#!/usr/bin/env python3
"""Smoke test of the read mapper on a GPU: the main path once, at real size.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded phase only

Phases (one process; each prints one JSON line with its compile and run
seconds and its checks, every check beside its limit):

  device     the platform must be "gpu" (no CPU fallback); prints the card,
             the compile-cache directory and nvidia-smi's name/power limit
  kernel     each hand-written kernel at real widths against its plain
             reference (the GRU kernel against the lax.scan GRU at B=8192,
             T=123, both layers and directions; the int8 windowed scan at
             Q=8192 x N=2^21 against the exact int8 top-k), plus their
             end-to-end times against what XLA makes of the plain versions
  main       an E. coli K-12 MG1655-length genome (4,641,652 bp, NCBI
             NC_000913.3) made from a seed -> `build-index` INT8FLAT at
             stride 1 -> `pipeline` on 16,384 simulated 150 bp reads at 1%
             error, writing SAM; checked against the simulated truth and
             against the FLAT oracle at HIGHEST precision on 512 reads
  serve      serve() in-process on that index: requests of 128, 1,024 and
             8,192 reads, then quit
  reach      every other engine at 2^19 rows, the SW rerank, 3 fine-tune
             steps, long reads and read pairs

Any failed check or exception exits non-zero, and then no result line is
printed.  The last line of a passing run is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GENOME_BP = 4_641_652      # E. coli K-12 MG1655, NCBI NC_000913.3
READ_LEN = 150
ERR = 0.01
# the run's sizes; tests call the phases with tiny ones
FULL = {
    "gru_batch": 8192,
    "scan_queries": 8192,
    "scan_rows": 1 << 21,
    "genome_bp": GENOME_BP,
    "reads": 16_384,
    "oracle_reads": 512,
    "reach_rows": 1 << 19,
    "serve": (128, 1024, 8192),
    "reach_reads": 1024,
    "sw_pairs": 1024,
    "finetune_batch": 512,
    "long_reads": 8,
    "long_len": 5000,
    "pairs": 256,
}
# build-index at stride 1 must leave the rest of the run its time; past
# this many seconds the main path rebuilds at stride 4 and says so
STRIDE1_BUDGET_S = 420.0


_COMPILE_S = [0.0]


def _count_compile(event: str, duration: float, **_kw) -> None:
    """jax.monitoring listener: seconds spent tracing, lowering and
    compiling, so each phase can split compile from run time."""
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(checks: list, name: str, value, limit, op: str, reason: str = ""):
    ok = {
        ">=": lambda a, b: a >= b,
        "<=": lambda a, b: a <= b,
        "==": lambda a, b: a == b,
    }[op](value, limit)
    entry = {"name": name, "value": value, "limit": f"{op} {limit}",
             "ok": bool(ok)}
    if reason:
        entry["reason"] = reason
    checks.append(entry)
    return ok


def timed(fn, *args, reps: int = 3):
    """(first-call seconds incl. compile, best steady seconds, result)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def mem_analysis(fn, *args) -> dict:
    import jax

    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


# ------------------------------------------------------------------ data


def make_genome(n_bp: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return np.array(list("ACGT"))[rng.integers(0, 4, n_bp)].tobytes().decode(
        "utf-32-le"
    )


def simulate_reads(genome: str, n_reads: int, read_len: int, err: float,
                   seed: int):
    """wgsim-style: uniform start, either strand, substitution errors."""
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome.encode(), np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    starts = rng.integers(0, len(genome) - read_len + 1, n_reads)
    strands = rng.integers(0, 2, n_reads)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = g[idx]
    rev = strands == 1
    reads[rev] = comp[reads[rev][:, ::-1]]
    mask = rng.random(reads.shape) < err
    reads[mask] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, int(mask.sum()))
    ]
    seqs = [r.tobytes().decode() for r in reads]
    names = [f"_{s}_{int(st)}_{i}" for i, (s, st) in
             enumerate(zip(starts, strands))]
    return seqs, names, starts, strands


def write_fasta(path: str, genome: str) -> None:
    with open(path, "w") as f:
        f.write(">synthetic_NC_000913_length\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i:i + 80] + "\n")


def write_fastq(path: str, seqs, names) -> None:
    with open(path, "w") as f:
        for s, n in zip(seqs, names):
            f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")


def cli(*argv) -> None:
    """Run the package CLI the way a user does (stdout kept off ours)."""
    from deepreadmapper_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}: {buf.getvalue()[-800:]}")


def truth_top1(ids, starts, strands, stride: int = 1, tol: int = 5):
    pos = (ids // 2) * stride
    return float(np.mean(
        (np.abs(pos.astype(np.int64) - starts) <= tol + stride - 1)
        & ((ids % 2) == strands)
    ))


def locus_agree(a, b, tol: int = 5) -> np.ndarray:
    return (np.abs(a // 2 - b // 2) <= tol) & ((a % 2) == (b % 2))


# ---------------------------------------------------------------- phases


def phase_device(ctx: dict) -> dict:
    import jax

    from deepreadmapper_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found {devs[0].platform!r}"
        )
    want = 4 if ctx["four"] else 1
    if len(devs) < want:
        raise SystemExit(f"needs {want} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    ctx["smi"] = smi.stdout.strip().splitlines()
    ctx["device"] = {"platform": devs[0].platform,
                     "kind": devs[0].device_kind, "count": len(devs)}
    return {"device_kind": devs[0].device_kind, "count": len(devs),
            "compile_cache": cache, "nvidia_smi": ctx["smi"], "checks": []}


def _encoder_fn(impl: str, unroll: int = 1, interpret: bool = False):
    import jax
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import encoder, gru_pallas as gp

    def enc(params, tokens):
        with jax.default_matmul_precision(encoder.MATMUL_PRECISION):
            x = params.embedding[tokens.astype(jnp.int32).T]
            p0, p1 = params.layers
            if impl == "kernel":
                h1 = gp.gru_bi_kernel(x, p0.w, p0.bzr, p0.r, p0.rbh, False,
                                      interpret=interpret)
                return h1, gp.gru_bi_kernel(h1, p1.w, p1.bzr, p1.r, p1.rbh,
                                            True, interpret=interpret)
            h1 = gp._scan_bi(x, p0.w, p0.bzr, p0.r, p0.rbh, False, unroll)
            return h1, gp._scan_bi(h1, p1.w, p1.bzr, p1.r, p1.rbh, True,
                                   unroll)

    return jax.jit(enc)


def _topk_lowering(shape) -> dict:
    import jax
    import jax.numpy as jnp

    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    out = {}
    for name, fn in (
        ("top_k", lambda v: jax.lax.top_k(v, 128)),
        ("approx_max_k", lambda v: jax.lax.approx_max_k(v, 128)),
    ):
        try:
            hlo = jax.jit(fn).lower(x).compile().as_text()
        except Exception as e:  # a refusal is itself the finding
            out[name] = f"{type(e).__name__}: {e}"[:300]
            continue
        ops = sorted({
            tok for tok in ("sort(", "custom-call", "__gpu$xla.gpu.topk",
                            "TopK", "topk")
            if tok in hlo
        })
        out[name] = ops
    return out


def phase_gru(ctx: dict) -> dict:
    """The GRU kernel against the lax.scan GRU: the encoder's two layers,
    both directions, at B=8192, T=123."""
    import jax.numpy as jnp

    from deepreadmapper_tpu.models import encoder

    checks: list = []
    res: dict = {}
    rng = np.random.default_rng(ctx["seed"])

    # --- GRU: the encoder's two layers, kernel vs lax.scan at B=8192
    sz = ctx["sizes"]
    params = encoder.load_params()
    tokens = jnp.asarray(
        rng.integers(7542, 7638, size=(sz["gru_batch"], encoder.MAX_LEN)),
        jnp.uint16,
    )
    times = {}
    outs = {}
    for name, fn in (("kernel", _encoder_fn("kernel", interpret=ctx["interpret"])),
                     ("xla_scan", _encoder_fn("xla")),
                     ("xla_scan_unroll4", _encoder_fn("xla", 4))):
        first, best, out = timed(fn, params, tokens)
        times[name] = {"first_s": first, "steady_s": best}
        outs[name] = out
    tol = 1e-4
    for i, layer in enumerate(("layer1_seq", "layer2_last")):
        err = float(jnp.max(jnp.abs(outs["kernel"][i] - outs["xla_scan"][i])))
        check(checks, f"gru_{layer}_max_abs_err", err, tol, "<=",
              "kernel products at 3xTF32 (fp32-level), scan at HIGHEST; "
              "sums in another order over 123 recurrent steps of "
              "tanh-bounded states")
    res[f"gru_B{sz['gru_batch']}_T123"] = times
    res["gru_memory"] = mem_analysis(
        _encoder_fn("kernel", interpret=ctx["interpret"]), params, tokens)
    res["checks"] = checks
    return res


def phase_scan(ctx: dict) -> dict:
    """The int8 windowed scan (kernel and plain XLA) against the exact int8
    top-k at Q=8192 x N=2^21, and the plain per-chunk top-k scan."""
    import jax
    import jax.numpy as jnp

    from deepreadmapper_tpu.index.int8_flat import (
        Int8FlatIndex,
        _int8_topk,
        _row_norms,
    )
    from deepreadmapper_tpu.ops import scan_kernel as sk

    checks: list = []
    res: dict = {}
    sz = ctx["sizes"]
    rng = np.random.default_rng(ctx["seed"])
    n, q = sz["scan_rows"], sz["scan_queries"]
    emb = np.tanh(rng.standard_normal((n, 128)).astype(np.float32))
    codes = np.clip(np.round(emb * 127), -127, 127).astype(np.int8)
    pick = rng.integers(0, n, q)
    qf = emb[pick] + 0.05 * rng.standard_normal((q, 128)).astype(np.float32)
    q8 = np.clip(np.round(qf * 127), -127, 127).astype(np.int8)
    r8 = jnp.asarray(codes)
    q8j = jnp.asarray(q8)
    qn = (q8.astype(np.int64) ** 2).sum(1).astype(np.float32)
    rn = _row_norms(r8)
    k = 128
    chunk = Int8FlatIndex._CHUNK  # the plain scan's chunk (2^17 rows)
    fns = {
        "kernel": functools.partial(
            sk.fused_scan_topk, k=k, chunk=sk.choose_chunk(n, "kernel"),
            impl="kernel", interpret=ctx["interpret"]),
        "xla_winmin": functools.partial(
            sk.fused_scan_topk, k=k, chunk=sk.choose_chunk(n, "xla"),
            impl="xla"),
        "xla_topk_scan": lambda a, r, nt: _int8_topk(
            a, r, rn, nt, k, chunk, False),
    }
    stimes = {}
    souts = {}
    nt = jnp.int32(n)
    for name, fn in fns.items():
        try:
            first, best, out = timed(fn, q8j, r8, nt, reps=2)
        except Exception as e:  # keep the other implementations' numbers
            stimes[name] = {"error": f"{type(e).__name__}: {e}"[:400]}
            check(checks, f"{name}_ran", 0, 1, "==")
            continue
        stimes[name] = {"first_s": first, "steady_s": best}
        souts[name] = out
    _, _, (d_ref, i_ref) = timed(
        lambda a: _int8_topk(a, r8, rn, nt, k, chunk, True), q8j, reps=0)
    d_ref = np.asarray(d_ref)
    i_ref = np.asarray(i_ref)
    for name in ("kernel", "xla_winmin"):
        if name not in souts:
            continue
        d_k = np.asarray(souts[name][0]) + qn[:, None]
        i_k = np.asarray(souts[name][1])
        # integer scores identical on ids both lists hold
        mism = 0
        for r in range(0, q, 64):
            common, a, b = np.intersect1d(i_k[r], i_ref[r],
                                          return_indices=True)
            mism += int(np.sum(d_k[r][a] != d_ref[r][b]))
        check(checks, f"int8_{name}_score_mismatch_on_shared_ids", mism, 0,
              "==", "integer arithmetic (int8 x int8 -> int32) is exact")
        kth = d_ref[:, -1:]
        recall = float(np.mean(np.minimum(
            1.0, np.sum(d_k <= kth, axis=1) / k)))
        n_win = n // sk.W
        check(checks, f"int8_{name}_tie_aware_recall@128", recall,
              1.0 - (k - 1) / n_win, ">=",
              "one survivor per 128-row window: C(k,2)/windows expected "
              "collisions per query; the limit allows twice that")
        top1 = float(np.mean(d_k[:, 0] == d_ref[:, 0]))
        check(checks, f"int8_{name}_top1_score_agreement", top1, 1.0, ">=",
              "the best row always survives its window")
    res[f"int8_scan_Q{q}_N{n}"] = stimes
    res["int8_kernel_memory"] = mem_analysis(fns["kernel"], q8j, r8, nt)
    res["topk_lowering"] = {
        str(s): _topk_lowering(s) for s in ((8192, 16384), (8192, 262144))
    }
    res["checks"] = checks
    return res


def _build_main_index(ctx: dict) -> dict:
    work = ctx["work"]
    genome = make_genome(ctx["sizes"]["genome_bp"], ctx["seed"])
    ctx["genome"] = genome
    fasta = os.path.join(work, "genome.fna")
    write_fasta(fasta, genome)
    ctx["fasta"] = fasta
    prefix = os.path.join(work, "idx_int8")
    t0 = time.perf_counter()
    cli("build-index", fasta, prefix, READ_LEN, 1, "--index-type", "INT8FLAT")
    t_build = time.perf_counter() - t0
    stride = 1
    cut = None
    if t_build > STRIDE1_BUDGET_S:
        shutil.rmtree(prefix)
        stride = 4
        cut = (f"stride-1 build took {t_build:.1f}s > {STRIDE1_BUDGET_S}s; "
               "rebuilt at stride 4")
        t0 = time.perf_counter()
        cli("build-index", fasta, prefix, READ_LEN, stride,
            "--index-type", "INT8FLAT")
        t_build = time.perf_counter() - t0
    ctx["prefix"] = prefix
    ctx["stride"] = stride
    return {"build_s": t_build, "stride": stride, "cut": cut}


def phase_main(ctx: dict) -> dict:
    from deepreadmapper_tpu.index.flat import FlatIndex
    from deepreadmapper_tpu.io import fasta as fio
    from deepreadmapper_tpu.models.encoder import Vectorizer
    from deepreadmapper_tpu.pipeline.build import embed_fasta_windows

    checks: list = []
    sz = ctx["sizes"]
    info = _build_main_index(ctx)
    work, stride = ctx["work"], ctx["stride"]
    n_reads, n_oracle = sz["reads"], sz["oracle_reads"]
    seqs, names, starts, strands = simulate_reads(
        ctx["genome"], n_reads, READ_LEN, ERR, ctx["seed"] + 1
    )
    fq = os.path.join(work, "reads.fastq")
    write_fastq(fq, seqs, names)
    ctx["reads"] = (seqs, names, starts, strands)
    out = os.path.join(work, "out_main")
    t0 = time.perf_counter()
    cli("pipeline", ctx["prefix"], fq, ctx["fasta"], 128, 128, 5, out)
    t_pipe = time.perf_counter() - t0
    ids = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    acc = truth_top1(ids[:, 0], starts, strands, stride)
    check(checks, "truth_top1_within_5bp", acc, 0.99, ">=",
          "1% substitution errors; simulated truth")
    with open(os.path.join(out, "results.sam")) as f:
        n_sam = sum(1 for line in f if not line.startswith("@"))
    check(checks, "sam_records", n_sam, n_reads, ">=")

    # FLAT oracle at HIGHEST over the fp32 window embeddings, 512 reads
    vec = Vectorizer()
    t0 = time.perf_counter()
    recs = fio.parse_fasta_records(ctx["fasta"])
    ref_emb = embed_fasta_windows(recs, READ_LEN, stride, vec)
    q_emb = vec.vectorize([f"<{s}>" for s in seqs[:n_oracle]])
    fi, fd = FlatIndex(ref_emb).search(q_emb, 8)
    t_oracle = time.perf_counter() - t0
    mine = ids[:n_oracle, 0]
    same_locus = locus_agree(mine, fi[:, 0])
    # tie-aware: the pipeline's top-1 is as close in fp32 as the oracle's
    d_mine = ((ref_emb[mine] - q_emb) ** 2).sum(1)
    tie = d_mine <= fd[:, 0] * (1 + 1e-5) + 1e-6
    agree = float(np.mean(same_locus | tie))
    check(checks, f"flat_oracle_top1_agreement_{n_oracle}", agree, 0.99,
          ">=",
          "int8 quantization can reorder near-equal neighbours; counted "
          "as agreement when the locus (+-5 bp, strand) or the fp32 "
          "distance ties")
    del ref_emb
    return {**info, "pipeline_s": t_pipe, "reads": n_reads,
            "oracle_s": t_oracle, "checks": checks}


def phase_serve(ctx: dict) -> dict:
    from deepreadmapper_tpu.pipeline.serve import serve

    checks: list = []
    seqs, names, starts, strands = ctx["reads"]
    sizes = ctx["sizes"]["serve"]
    reqs = []
    for j, n in enumerate(sizes):
        fq = os.path.join(ctx["work"], f"serve_{n}.fastq")
        write_fastq(fq, seqs[:n], names[:n])
        reqs.append({"id": f"r{j}", "fastq": fq,
                     "output_dir": os.path.join(ctx["work"], f"serve_{j}")})
    reqs.append({"cmd": "quit"})
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    t0 = time.perf_counter()
    n_served = serve(ctx["prefix"], ctx["fasta"], in_stream=stdin,
                     out_stream=stdout)
    t_serve = time.perf_counter() - t0
    replies = [json.loads(x) for x in stdout.getvalue().splitlines() if x]
    oks = [r for r in replies if r.get("id", "").startswith("r")]
    check(checks, "requests_ok", sum(bool(r.get("ok")) for r in oks),
          len(sizes), "==")
    check(checks, "served", n_served, len(sizes), "==")
    return {"serve_s": t_serve, "replies": replies, "checks": checks}


def _reach_genome(ctx: dict) -> str:
    """The first 2^19/2 windows' worth of the main genome (both strands
    give 2^19 rows at stride 1)."""
    if "genome" not in ctx:
        ctx["genome"] = make_genome(ctx["sizes"]["genome_bp"], ctx["seed"])
    return ctx["genome"][: ctx["sizes"]["reach_rows"] // 2 + READ_LEN - 1]


def _reach_engines(ctx: dict, checks: list) -> dict:
    """Each other engine at 2^19 rows, built and searched through the CLI,
    checked against the FLAT oracle of the same index."""
    work, sz = ctx["work"], ctx["sizes"]
    genome = _reach_genome(ctx)
    fasta = os.path.join(work, "reach.fna")
    write_fasta(fasta, genome)
    seqs, names, starts, strands = simulate_reads(
        genome, sz["reach_reads"], READ_LEN, ERR, ctx["seed"] + 2)
    fq = os.path.join(work, "reach.fastq")
    write_fastq(fq, seqs, names)
    engines = [
        ("FLAT", [], 0.99),
        ("PQFLAT", ["--opq"], 0.80),
        ("IVFINT8", [], 0.95),
        ("IVFPQ", [], 0.80),
        ("HNSWFLAT", ["--build-mode", "knn"], 0.95),
    ]
    out: dict = {}
    tops: dict = {}
    for name, extra, floor in engines:
        prefix = os.path.join(work, f"reach_{name}")
        t0 = time.perf_counter()
        cli("build-index", fasta, prefix, READ_LEN, 1, "--index-type", name,
            *extra)
        t_build = time.perf_counter() - t0
        res_dir = os.path.join(work, f"reach_out_{name}")
        t0 = time.perf_counter()
        cli("pipeline", prefix, fq, fasta, 128, 16, 5, res_dir, "--no-sam")
        t_search = time.perf_counter() - t0
        top = np.load(os.path.join(res_dir, "indices.npy"))[:, 0].astype(
            np.int64)
        tops[name] = top
        out[name] = {"build_s": t_build, "pipeline_s": t_search,
                     "truth_top1": truth_top1(top, starts, strands)}
        if name != "FLAT":
            agree = float(np.mean(locus_agree(top, tops["FLAT"])))
            check(checks, f"{name}_vs_flat_top1_locus", agree, floor, ">=",
                  "approximate engine against the exact oracle")
        else:
            check(checks, "FLAT_truth_top1", out[name]["truth_top1"], 0.97,
                  ">=", "exact search; 1% substitution errors")
    ctx["reach"] = (fasta, fq, seqs, names, starts, strands)
    return out


def phase_reach(ctx: dict) -> dict:
    from deepreadmapper_tpu.ops import sw
    from deepreadmapper_tpu.tokenizer import strings_to_bytes

    checks: list = []
    res = {"engines": _reach_engines(ctx, checks)}
    fasta, fq, seqs, names, starts, strands = ctx["reach"]
    work = ctx["work"]
    rng = np.random.default_rng(ctx["seed"] + 3)

    # --rerank sw through the pipeline, and the batched SW kernel against
    # the scalar DP on 1,024 pairs of 150 x 152
    t0 = time.perf_counter()
    cli("pipeline", os.path.join(work, "reach_FLAT"), fq, fasta, 128, 5, 5,
        os.path.join(work, "reach_sw"), "--rerank", "sw", "--no-sam")
    res["rerank_sw_pipeline_s"] = time.perf_counter() - t0
    n_sw = ctx["sizes"]["sw_pairs"]
    a = ["".join(rng.choice(list("ACGT"), 150)) for _ in range(n_sw)]
    b = ["<" + s[:75] + "".join(rng.choice(list("ACGT"), 75)) + ">"
         for s in a]
    am, al = strings_to_bytes(a)
    bm, bl = strings_to_bytes(b)
    t0 = time.perf_counter()
    got = sw.sw_scores(am, al, bm, bl)
    res[f"sw_{n_sw}_s"] = time.perf_counter() - t0
    want = np.array([sw.sw_score_reference(x, y) for x, y in zip(a, b)])
    check(checks, "sw_mismatches_vs_scalar_dp", int(np.sum(got != want)), 0,
          "==", "integer DP")

    # 3 fine-tune steps: the GRU custom_vjp backward on the card
    t0 = time.perf_counter()
    from deepreadmapper_tpu.pipeline.finetune import finetune

    _params, losses = finetune(fasta, READ_LEN, steps=3,
                               batch=ctx["sizes"]["finetune_batch"],
                               seed=ctx["seed"])
    res["finetune_3_steps_s"] = time.perf_counter() - t0
    res["finetune_losses"] = losses
    check(checks, "finetune_losses_finite",
          int(np.all(np.isfinite(losses))), 1, "==")

    # 8 long reads of 5 kb through --long-reads
    genome = _reach_genome(ctx)
    n_long, long_len = ctx["sizes"]["long_reads"], ctx["sizes"]["long_len"]
    lr_starts = rng.integers(0, len(genome) - long_len, n_long)
    lr_seqs = [genome[s:s + long_len] for s in lr_starts]
    lr_names = [f"_{s}_0_{i}" for i, s in enumerate(lr_starts)]
    lq = os.path.join(work, "long.fastq")
    write_fastq(lq, lr_seqs, lr_names)
    lo = os.path.join(work, "long_out")
    t0 = time.perf_counter()
    cli("pipeline", os.path.join(work, "reach_FLAT"), lq, fasta, 128, 16, 5,
        lo, "--long-reads", "--no-sam")
    res["long_reads_s"] = time.perf_counter() - t0
    lids = np.load(os.path.join(lo, "indices.npy"))[:, 0].astype(np.int64)
    lacc = float(np.mean(np.abs(lids // 2 - lr_starts) <= 50))
    check(checks, "long_read_start_within_50bp", lacc, 0.75, ">=",
          "error-free 5 kb reads, chained read-start placement")

    # 256 read pairs (FR, 150 bp mates, ~400 bp inserts)
    comp = str.maketrans("ACGT", "TGCA")
    p_starts = rng.integers(0, len(genome) - 500, ctx["sizes"]["pairs"])
    r1 = [genome[s:s + 150] for s in p_starts]
    r2 = [genome[s + 250:s + 400].translate(comp)[::-1] for s in p_starts]
    pn = [f"_{s}_0_{i}" for i, s in enumerate(p_starts)]
    f1, f2 = os.path.join(work, "r1.fastq"), os.path.join(work, "r2.fastq")
    write_fastq(f1, r1, pn)
    write_fastq(f2, r2, pn)
    po = os.path.join(work, "paired_out")
    t0 = time.perf_counter()
    cli("pipeline", os.path.join(work, "reach_FLAT"), f1, fasta, 128, 16, 5,
        po, "--paired2", f2, "--mapq")
    res["paired_s"] = time.perf_counter() - t0
    with open(os.path.join(po, "results.sam")) as f:
        flags = [int(line.split("\t")[1]) for line in f
                 if not line.startswith("@")]
    primary = [fl for fl in flags if not fl & 0x900]
    proper = float(np.mean([(fl & 0x2) != 0 for fl in primary]))
    check(checks, "paired_proper_fraction", proper, 0.9, ">=",
          "error-free FR pairs, 400 bp outer insert")
    res["checks"] = checks
    return res


def phase_four_cards(ctx: dict) -> dict:
    """Sharded INT8FLAT over a data=1 x shard=4 mesh against the 1-card
    scan over the same codes."""
    import jax

    from deepreadmapper_tpu.index.int8_flat import Int8FlatIndex
    from deepreadmapper_tpu.index.registry import load_index
    from deepreadmapper_tpu.models.encoder import Vectorizer

    checks: list = []
    work = ctx["work"]
    sz = ctx["sizes"]
    genome = make_genome(sz["genome_bp"], ctx["seed"])
    ctx["genome"] = genome
    fasta = os.path.join(work, "genome.fna")
    write_fasta(fasta, genome)
    prefix = os.path.join(work, "idx_sharded")
    t0 = time.perf_counter()
    cli("build-index", fasta, prefix, READ_LEN, 1, "--index-type", "INT8FLAT",
        "--shards", 4)
    t_build = time.perf_counter() - t0
    seqs, names, starts, strands = simulate_reads(genome, sz["reads"],
                                                  READ_LEN, ERR,
                                                  ctx["seed"] + 1)
    fq = os.path.join(work, "reads.fastq")
    write_fastq(fq, seqs, names)
    out = os.path.join(work, "out_sharded")
    t0 = time.perf_counter()
    cli("pipeline", prefix, fq, fasta, 128, 128, 5, out)
    t_pipe = time.perf_counter() - t0
    ids_sh = np.load(os.path.join(out, "indices.npy")).astype(np.int64)
    check(checks, "sharded_truth_top1", truth_top1(ids_sh[:, 0], starts,
                                                   strands), 0.99, ">=")

    engine, _cfg = load_index(prefix)
    codes_dev = engine._device()[3]
    by_shard: dict = {}
    for piece in codes_dev.addressable_shards:
        by_shard.setdefault(piece.index[0].start or 0, set()).add(
            piece.device.id)
    placed = sorted(by_shard.values(), key=min)
    disjoint = len(set().union(*placed)) == sum(len(p) for p in placed)
    check(checks, "shards_on_distinct_cards",
          len(placed) if disjoint else 0, 4, "==",
          "each shard's codes on cards of its own, not all on device 0")
    placed = [sorted(p) for p in placed]
    # the 1-card scan over the same codes (shards concatenated in order)
    codes = np.concatenate([s.codes for s in engine.subs])[: engine.ntotal]
    scales = {s.scale for s in engine.subs}
    one = Int8FlatIndex(codes, engine.subs[0].scale, engine.ntotal)
    vec = Vectorizer()
    q = vec.vectorize([f"<{s}>" for s in seqs])
    with jax.default_device(jax.devices()[0]):
        i1, d1 = one.search(q, 128)
    i4, d4 = engine.search(q, 128)
    top1 = float(np.mean(i1[:, 0] == i4[:, 0]) if len(scales) == 1
                 else np.mean(locus_agree(i1[:, 0], i4[:, 0])))
    check(checks, "sharded_vs_1card_top1", top1, 0.99, ">=",
          "same codes; windowed scans differ only in window boundaries")
    kth = d1[:, -1:]
    recall = float(np.mean(np.minimum(1.0, np.sum(d4 <= kth * (1 + 1e-6),
                                                  axis=1) / 128)))
    check(checks, "sharded_vs_1card_tie_aware_recall@128", recall, 0.98,
          ">=", "one survivor per 128-row window on each side")
    return {"build_s": t_build, "pipeline_s": t_pipe,
            "shard_devices": placed, "shard_scales": len(scales),
            "checks": checks}


PHASES = {
    "device": phase_device,
    "gru": phase_gru,
    "scan": phase_scan,
    "main": phase_main,
    "serve": phase_serve,
    "reach": phase_reach,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four cards")
    ap.add_argument("--phase", action="append", choices=list(PHASES),
                    help="run only these phases (device always runs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    ctx = {"seed": args.seed, "four": args.four_cards, "sizes": FULL,
           "interpret": False}
    if args.four_cards:
        names = ["device", "four_cards"]
        table = {**PHASES, "four_cards": phase_four_cards}
    else:
        names = ["device"] + [p for p in PHASES if p != "device"
                              and (not args.phase or p in args.phase)]
        table = PHASES
    import jax

    jax.monitoring.register_event_duration_secs_listener(_count_compile)
    ctx["work"] = tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO)
    failed = []
    try:
        for name in names:
            t0 = time.perf_counter()
            c0 = _COMPILE_S[0]
            try:
                res = table[name](ctx)
                ok = all(c["ok"] for c in res.get("checks", []))
            except SystemExit:
                raise
            except Exception as e:  # report and go on to the next phase
                res = {"error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
                ok = False
            total = time.perf_counter() - t0
            compile_s = _COMPILE_S[0] - c0
            emit({"phase": name, "ok": ok, "compile_s": compile_s,
                  "run_s": total - compile_s, **res})
            if not ok:
                failed.append(name)
                if name == "device":
                    break
    finally:
        shutil.rmtree(ctx["work"], ignore_errors=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    for line in ctx["smi"]:
        print(f"nvidia-smi: {line}")
    print(result_line(ctx["device"]))
    return 0


def result_line(device: dict) -> str:
    """The last line of a passing run, with nothing more in it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


if __name__ == "__main__":
    sys.exit(main())
