"""2-process jax.distributed CPU test: init, cross-process collectives, and
the per-host build-own-shard / load-own-shard orchestration
(parallel/distributed.py).

The reference has no distributed code (SURVEY.md §2.7); this is the
framework's multi-host story, exercised for real across two OS processes
with the Gloo-backed CPU collective client: each process builds and
persists ONLY its own shard, then process 0 reloads the full manifest and
verifies a merged search against ground truth.
"""

import os
import socket
import subprocess
import sys

_CHILD = r"""
import os
import sys

sys.path.insert(0, os.getcwd())  # repo root
port, pid, prefix = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2
assert jax.process_index() == pid
assert len(jax.devices()) == 2 and len(jax.local_devices()) == 1

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# --- cross-process collective: psum over a process-spanning mesh ---
mesh = Mesh(np.asarray(jax.devices()).reshape(2), ("d",))
local = jnp.full((1, 4), float(pid + 1))
garr = jax.make_array_from_single_device_arrays(
    (2, 4), NamedSharding(mesh, P("d", None)),
    [jax.device_put(local, jax.local_devices()[0])],
)
out = jax.jit(
    jax.shard_map(lambda x: jax.lax.psum(x, "d"), mesh=mesh,
                  in_specs=P("d", None), out_specs=P("d", None))
)(garr)
assert np.all(np.asarray(out.addressable_shards[0].data) == 3.0)

# --- per-host shard orchestration ---
from deepreadmapper_tpu.parallel import distributed as dist

n, d = 100, 32
X = np.random.default_rng(7).standard_normal((n, d)).astype(np.float32)
mine = dist.build_own_shards(
    lambda s, e: X[s:e], n, n_shards=2, index_prefix=prefix,
    index_type="INT8FLAT",
)
assert mine == [pid], mine
multihost_utils.sync_global_devices("shards-built")

if pid == 0:
    # full restore (single-process view over every shard dir the two
    # processes wrote) + host-side merged search vs ground truth
    subs, ids, meta = dist.load_own_shards(
        prefix, process_id=0, num_processes=1
    )
    assert ids == [0, 1] and int(meta["ntotal"]) == n
    assert meta["inner"] == "INT8FLAT"
    per = 50
    q = X[::10]  # rows 0,10,...,90 span both shards
    d_all, i_all = [], []
    for si, sub in enumerate(subs):
        i_loc, d_loc = sub.search(q, 3)
        i_all.append(np.where(i_loc >= 0, i_loc + si * per, -1))
        d_all.append(d_loc)
    dm = np.concatenate(d_all, 1)
    im = np.concatenate(i_all, 1)
    top1 = np.take_along_axis(im, np.argsort(dm, 1)[:, :1], 1)[:, 0]
    assert np.array_equal(top1, np.arange(0, n, 10)), top1
    # partial restore: "host 1 of 2" must load only shard_1
    subs1, ids1, _ = dist.load_own_shards(
        prefix, process_id=1, num_processes=2
    )
    assert ids1 == [1] and len(subs1) == 1
multihost_utils.sync_global_devices("verified")

# --- TRUE cross-process sharded search: each process contributes ONLY its
# own shard to the process-spanning device arrays; the shard_map program and
# its all_gather merge run across BOTH processes over the collective client
from deepreadmapper_tpu.parallel.sharded_ann import ShardedANNIndex

idx = ShardedANNIndex.load_distributed(prefix)
assert idx._local_only and len(idx.subs) == 1 and idx.ntotal == n
q = X[::10]  # identical replicated query batch on every process
gids, gd = idx.search(q, 3)
assert gids.shape == (10, 3)
# int8 top-1 must be the query row itself (global ids span both shards)
assert np.array_equal(gids[:, 0], np.arange(0, n, 10)), gids[:, 0]
assert np.all(np.diff(gd, axis=1) >= -1e-4)
multihost_utils.sync_global_devices("distributed-search-ok")

# --- same flow for the >100M-row engine: per-host IVF builds (independent
# coarse quantizers), cross-process probe -> per-host plan inversion ->
# slab scan -> all_gather merge
ivf_prefix = prefix + "_ivf"
dist.build_own_shards(
    lambda s, e: X[s:e], n, n_shards=2, index_prefix=ivf_prefix,
    index_type="IVFINT8",
)
multihost_utils.sync_global_devices("ivf-shards-built")
ivf = ShardedANNIndex.load_distributed(ivf_prefix)
assert ivf._local_only and ivf.kind == "ivfint8"
vids, vd = ivf.search(q, 3, ef=1_000_000)  # full probe = exhaustive
assert np.array_equal(vids[:, 0], np.arange(0, n, 10)), vids[:, 0]
multihost_utils.sync_global_devices("distributed-ivf-ok")

# --- PQFLAT across processes (per-shard codebooks, bf16 ADC fused merge)
from deepreadmapper_tpu.config import BuildConfig

pq_prefix = prefix + "_pq"
dist.build_own_shards(
    lambda s, e: X[s:e], n, n_shards=2, index_prefix=pq_prefix,
    cfg=BuildConfig(nbits=4, kmeans_iters=5), index_type="PQFLAT",
)
multihost_utils.sync_global_devices("pq-shards-built")
pq = ShardedANNIndex.load_distributed(pq_prefix)
assert pq._local_only and pq.kind == "pqflat"
pids_, pd_ = pq.search(q, 3)
assert pids_.shape == (10, 3) and pids_.min() >= 0 and pids_.max() < n
top1_pq = float(np.mean(pids_[:, 0] == np.arange(0, n, 10)))
assert top1_pq >= 0.8, top1_pq  # PQ4 quantization noise allowance
multihost_utils.sync_global_devices("distributed-pq-ok")

# --- FLAT across processes (exact): must equal ground truth bit-for-bit
fl_prefix = prefix + "_flat"
dist.build_own_shards(
    lambda s, e: X[s:e], n, n_shards=2, index_prefix=fl_prefix,
    index_type="FLAT",
)
multihost_utils.sync_global_devices("flat-shards-built")
fl = ShardedANNIndex.load_distributed(fl_prefix)
fids_, fd_ = fl.search(q, 3)
assert np.array_equal(fids_[:, 0], np.arange(0, n, 10)), fids_[:, 0]
assert np.allclose(fd_[:, 0], 0.0, atol=1e-4)
multihost_utils.sync_global_devices("distributed-flat-ok")
print(f"CHILD{pid}-OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_build_and_reload(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    prefix = str(tmp_path / "sharded_idx")
    port = _free_port()
    env = dict(os.environ)
    # one CPU device per process (the parent conftest's 8-device XLA flag
    # would leak in); children select CPU via jax.config, not env
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(child), str(port), str(pid), prefix],
            cwd=os.getcwd(), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"child {pid} failed:\n{out}"
    assert "CHILD0-OK" in outs[0]
    assert "CHILD1-OK" in outs[1]
    # both shard dirs + the manifest written by process 0 exist on disk
    assert os.path.exists(os.path.join(prefix, "sharded.txt"))
    assert os.path.exists(os.path.join(prefix, "shard_0", "int8.npz"))
    assert os.path.exists(os.path.join(prefix, "shard_1", "int8.npz"))

_CHILD_PIPELINE = r"""
import os
import sys

sys.path.insert(0, os.getcwd())
port, pid, prefix, outdir = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
import numpy as np
from jax.experimental import multihost_utils

from deepreadmapper_tpu.pipeline.build import build_index_distributed
from deepreadmapper_tpu.pipeline.search import run_pipeline

# per-host sharded BUILD: each process embeds ONLY its half of the genome's
# window rows and persists its own shard; process 0 writes manifest+config
build_index_distributed(
    "tests/data/ecoli_150.fna", prefix, 150,
    index_type="INT8FLAT", n_shards=2,
)
multihost_utils.sync_global_devices("built")

# registry auto-selects load_distributed under 2 processes: each host loads
# only its shard; the pipeline embeds the (replicated) reads locally, the
# sharded search merges across processes, process 0 writes npy + SAM
res = run_pipeline(
    prefix, "tests/data/test_data.fastq", "tests/data/ecoli_150.fna",
    ef=128, k=16, output_dir=outdir,
)
ids = res["neighbors"]
assert ids.shape == (150, 16), ids.shape
names = [l[1:] for l in open("tests/data/test_data.fastq").read().splitlines()[0::4]]
hits = sum(
    bool(np.any(np.abs((ids[r] // 2).astype(np.int64)
                       - (int(nm.split("_")[1]) - 1)) <= 2))
    for r, nm in enumerate(names)
)
assert hits >= 135, f"{hits}/150"
multihost_utils.sync_global_devices("pipeline-done")
print(f"CHILD{pid}-OK", flush=True)
"""


_CHILD_PAIRED = r"""
import os
import sys

sys.path.insert(0, os.getcwd())
port, pid, prefix, outdir = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
import numpy as np
from jax.experimental import multihost_utils

from deepreadmapper_tpu.io import fasta as fasta_io
from deepreadmapper_tpu.pipeline.build import build_index_distributed
from deepreadmapper_tpu.pipeline.search import run_pipeline_paired

ref = "tests/data/ecoli_150.fna"
build_index_distributed(ref, prefix, 150, index_type="INT8FLAT", n_shards=2)
multihost_utils.sync_global_devices("built")

# simulate 8 proper FR pairs from the fixture genome (every host writes
# its own copy of the read files — identical content)
genome = fasta_io.parse_fasta_records(ref)[0].tobytes().decode()
comp = str.maketrans("ACGT", "TGCA")
isize, L = 400, 150
f1 = os.path.join(outdir + f"_in{pid}", "r1.fastq")
f2 = os.path.join(outdir + f"_in{pid}", "r2.fastq")
os.makedirs(os.path.dirname(f1), exist_ok=True)
starts = [0, 50, 100, 150, 200, 250, 300, 400]
with open(f1, "w") as a, open(f2, "w") as b:
    for i, s in enumerate(starts):
        a.write(f"@p{i}\n{genome[s:s+L]}\n+\n{'I'*L}\n")
        m = genome[s+isize-L:s+isize].translate(comp)[::-1]
        b.write(f"@p{i}\n{m}\n+\n{'I'*L}\n")

res = run_pipeline_paired(prefix, f1, f2, ref, k=8, output_dir=outdir)
assert res["n_proper"] == len(starts), res["n_proper"]
multihost_utils.sync_global_devices("paired-done")
print(f"CHILD{pid}-OK", flush=True)
"""


def test_two_process_paired_pipeline(tmp_path):
    """Paired-end mapping across two jax.distributed processes: per-host
    shard builds, both ends' SPMD searches merge across hosts, pair
    resolution runs identically everywhere, process 0 writes the outputs."""
    prefix = str(tmp_path / "pp_idx")
    outdir = str(tmp_path / "pp_out")
    child = tmp_path / "child_paired.py"
    child.write_text(_CHILD_PAIRED)
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(child), str(port), str(pid), prefix, outdir],
            cwd=os.getcwd(), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"child {pid} failed:\n{out}"
    assert "CHILD0-OK" in outs[0] and "CHILD1-OK" in outs[1]
    import numpy as np

    ids = np.load(os.path.join(outdir, "indices.npy"))
    assert ids.shape[0] == 16  # 8 R1 rows + 8 R2 rows
    sam = [l for l in open(os.path.join(outdir, "results.sam"))
           if not l.startswith("@")]
    primaries = [l.split("\t") for l in sam
                 if int(l.split("\t")[1]) & 0x900 == 0]
    assert len(primaries) == 16
    assert all(int(f[1]) & 0x2 for f in primaries)  # every pair proper


_CHILD_SERVE = r"""
import io
import json
import os
import sys

sys.path.insert(0, os.getcwd())
port, pid, prefix, outdir = (
    sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
from jax.experimental import multihost_utils

from deepreadmapper_tpu.pipeline.build import build_index_distributed
from deepreadmapper_tpu.pipeline.serve import serve

build_index_distributed(
    "tests/data/ecoli_150.fna", prefix, 150,
    index_type="INT8FLAT", n_shards=2,
)
multihost_utils.sync_global_devices("built")

# one daemon per host, the SAME request stream on every host (the serve
# loop runs the SPMD pipeline per request; process 0 writes the outputs)
reqs = "".join(json.dumps(r) + "\n" for r in [
    {"id": "r1", "fastq": "tests/data/test_data.fastq",
     "output_dir": outdir, "k": 8},
    {"id": "r2", "fastq": "tests/data/test_data.fastq",
     "output_dir": outdir + "_2", "k": 4, "write_sam": False},
    {"cmd": "quit"},
])
out = io.StringIO()
n = serve(prefix, "tests/data/ecoli_150.fna",
          in_stream=io.StringIO(reqs), out_stream=out)
lines = [json.loads(l) for l in out.getvalue().splitlines()]
assert n == 2, n
assert lines[0]["ready"] and lines[1]["ok"] and lines[2]["ok"]
assert lines[1]["num_queries"] == 150
multihost_utils.sync_global_devices("served")
print(f"CHILD{pid}-OK", flush=True)
"""


def test_two_process_serve_daemon(tmp_path):
    """Distributed serving: one daemon per host consuming the same JSONL
    request stream; every request runs the SPMD sharded search across both
    processes and only process 0 writes outputs."""
    prefix = str(tmp_path / "srv_idx")
    outdir = str(tmp_path / "srv_out")
    child = tmp_path / "child_serve.py"
    child.write_text(_CHILD_SERVE)
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(child), str(port), str(pid), prefix, outdir],
            cwd=os.getcwd(), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"child {pid} failed:\n{out}"
    assert "CHILD0-OK" in outs[0] and "CHILD1-OK" in outs[1]
    import numpy as np

    ids = np.load(os.path.join(outdir, "indices.npy"))
    assert ids.shape == (150, 8)
    assert os.path.exists(os.path.join(outdir, "results.sam"))
    assert not os.path.exists(os.path.join(outdir + "_2", "results.sam"))


def test_two_process_pipeline_fastq_to_sam(tmp_path):
    """Full multi-host deployment end-to-end: two jax.distributed
    processes each EMBED + BUILD only their own genome slice/shard
    (build_index_distributed), load only their shard, and run the FASTQ
    pipeline; the sharded search merges across processes and exactly one
    host writes the outputs."""
    prefix = str(tmp_path / "dp_idx")
    outdir = str(tmp_path / "dp_out")

    child = tmp_path / "child_pipeline.py"
    child.write_text(_CHILD_PIPELINE)
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(child), str(port), str(pid), prefix, outdir],
            cwd=os.getcwd(), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"child {pid} failed:\n{out}"
    assert "CHILD0-OK" in outs[0] and "CHILD1-OK" in outs[1]
    # process 0 wrote the outputs exactly once
    import numpy as np

    ids = np.load(os.path.join(outdir, "indices.npy"))
    assert ids.shape == (150, 16)
    sam = open(os.path.join(outdir, "results.sam")).read().splitlines()
    assert sum(1 for l in sam if not l.startswith("@")) == 150 * 16
