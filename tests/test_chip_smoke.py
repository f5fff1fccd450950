"""chip_smoke.py on the CPU: its refusal without a GPU, the shape of its
last line, and its kernel phases at tiny sizes (kernels in interpret
mode)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TINY = {
    **cs.FULL,
    "gru_batch": 8, "scan_queries": 128, "scan_rows": 1 << 18,
    "genome_bp": 6000, "reads": 256, "oracle_reads": 64,
    "reach_rows": 2048, "serve": (16, 32, 64), "reach_reads": 128,
    "sw_pairs": 16, "finetune_batch": 8, "long_reads": 2,
    "long_len": 600, "pairs": 16,
}


def tiny_ctx(tmp_path, **kw):
    return {"seed": 0, "four": False, "interpret": True, "sizes": TINY,
            "work": str(tmp_path), **kw}


def _run(cwd, script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    proc = _run(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a GPU" in proc.stderr + proc.stdout


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # its work directory is removed on the way out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["chip_smoke.py"]


def test_result_line_shape():
    line = cs.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                           "count": 1, "extra": "dropped"})
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


def test_check_records_value_limit_and_verdict():
    checks = []
    assert cs.check(checks, "a", 0.5, 0.9, ">=", "why") is False
    assert cs.check(checks, "b", 3, 3, "==") is True
    assert checks[0] == {"name": "a", "value": 0.5, "limit": ">= 0.9",
                         "ok": False, "reason": "why"}
    assert checks[1]["ok"] is True


def test_simulated_reads_come_from_the_genome():
    genome = cs.make_genome(3000, 0)
    assert len(genome) == 3000 and set(genome) <= set("ACGT")
    seqs, names, starts, strands = cs.simulate_reads(genome, 32, 150, 0.0, 1)
    comp = str.maketrans("ACGT", "TGCA")
    for s, st, fw in zip(seqs, starts, strands):
        want = genome[st:st + 150]
        assert s == (want.translate(comp)[::-1] if fw else want)
    assert names[3].split("_")[1] == str(starts[3])


def test_gru_phase_tiny(tmp_path):
    res = cs.phase_gru(tiny_ctx(tmp_path))
    assert all(c["ok"] for c in res["checks"]), res["checks"]
    assert set(res["gru_B8_T123"]) == {"kernel", "xla_scan",
                                      "xla_scan_unroll4"}


def test_scan_phase_tiny(tmp_path):
    res = cs.phase_scan(tiny_ctx(tmp_path))
    assert all(c["ok"] for c in res["checks"]), res["checks"]
    assert len(res["checks"]) == 6
