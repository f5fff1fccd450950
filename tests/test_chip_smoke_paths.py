"""chip_smoke.py's main-path, serve and four-card phases on the CPU at tiny
sizes: the same entry points and checks as on the card."""

import pytest

from test_chip_smoke import cs, tiny_ctx


def test_main_and_serve_phases_tiny(tmp_path):
    ctx = tiny_ctx(tmp_path)
    res = cs.phase_main(ctx)
    by = {c["name"]: c for c in res["checks"]}
    assert res["stride"] == 1 and res["cut"] is None
    assert by["sam_records"]["ok"]
    assert by["flat_oracle_top1_agreement_64"]["ok"], by
    # 256 reads at 1% error on a 6 kbp genome: most map to their truth
    assert by["truth_top1_within_5bp"]["value"] >= 0.95
    served = cs.phase_serve(ctx)
    assert all(c["ok"] for c in served["checks"]), served


def test_four_cards_phase_on_virtual_devices(tmp_path):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    res = cs.phase_four_cards(tiny_ctx(tmp_path, four=True))
    by = {c["name"]: c for c in res["checks"]}
    assert by["shards_on_distinct_cards"]["ok"]
    assert by["sharded_vs_1card_top1"]["ok"]
    assert by["sharded_vs_1card_tie_aware_recall@128"]["ok"]
