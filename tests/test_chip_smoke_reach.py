"""chip_smoke.py's reach phase on the CPU at tiny sizes: every other engine,
the SW rerank, fine-tune steps, long reads and read pairs."""

from test_chip_smoke import cs, tiny_ctx


def test_reach_phase_tiny(tmp_path):
    res = cs.phase_reach(tiny_ctx(tmp_path))
    by = {c["name"]: c for c in res["checks"]}
    for name in ("sw_mismatches_vs_scalar_dp", "finetune_losses_finite",
                 "IVFINT8_vs_flat_top1_locus", "HNSWFLAT_vs_flat_top1_locus",
                 "long_read_start_within_50bp"):
        assert by[name]["ok"], by[name]
    assert set(res["engines"]) == {"FLAT", "PQFLAT", "IVFINT8", "IVFPQ",
                                   "HNSWFLAT"}
