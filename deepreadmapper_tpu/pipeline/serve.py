"""Serving daemon: one resident index, many mapping requests.

The reference has no serving story — every `pipeline` invocation pays the
full index load (main.cpp:34-47) and, in this framework's case, the device
upload + XLA compile again.  At genome scale that setup dominates
small-batch latency (index upload is GBs through the host<->device link;
XLA compiles cost seconds per shape signature).  `serve`
loads the engine and the index-matched encoder ONCE, then answers requests
over a line-delimited-JSON protocol on stdin/stdout, so steady-state
requests run at the measured warm search rate.

Protocol (one JSON object per line):

  request:  {"fastq": "/path/reads.fastq", "output_dir": "/path/out",
             "id": "r1",                       # optional echo tag
             "ef": 128, "k": 128, "k_clusters": 5,   # optional overrides
             "rerank": "l2", "dense_rerank": false,
             "cigar": false, "write_sam": true,
             "search_stats": false}   # true -> effort counters in response
                                      # (IVF engines; forces the host-plan
                                      # path — a tuning mode)
  response: {"id": "r1", "ok": true, "num_queries": 150,
             "t_embed": ..., "t_search": ..., "t_post": ...}
  error:    {"id": "r1", "ok": false, "error": "..."}   (daemon stays up)
  shutdown: {"cmd": "quit"}  ->  {"ok": true, "quit": true}

Anything the pipeline writes to stdout is routed to stderr while serving so
the protocol stream stays parseable.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

from deepreadmapper_tpu.config import SearchConfig
from deepreadmapper_tpu.index.registry import load_index
from deepreadmapper_tpu.pipeline.search import (
    run_pipeline,
    vectorizer_for_index,
)

# request keys forwarded to run_pipeline verbatim
_REQ_KEYS = (
    "ef", "k", "k_clusters", "output_dir", "use_dynamic", "use_streaming",
    "rerank", "dense_rerank", "write_sam", "cigar", "mapq", "long_reads",
    "qual", "sort", "bam", "mark_dups", "read_group",
)


def serve(
    index_prefix: str,
    ref_file: str,
    in_stream=None,
    out_stream=None,
    search_cfg: SearchConfig | None = None,
    defaults: dict | None = None,
) -> int:
    """Blocking serve loop; returns the number of requests answered."""
    in_stream = in_stream if in_stream is not None else sys.stdin
    out_stream = out_stream if out_stream is not None else sys.stdout
    defaults = defaults or {}

    def reply(obj):
        out_stream.write(json.dumps(obj) + "\n")
        out_stream.flush()

    t0 = time.time()
    with contextlib.redirect_stdout(sys.stderr):
        engine, config = load_index(index_prefix)
        vectorizer = vectorizer_for_index(index_prefix, config)
    reply({
        "ok": True,
        "ready": True,
        "index_type": config.get("index_type"),
        "n_vects": int(config.get("n_vects", 0)),
        "stride": int(config.get("stride", 1)),
        "t_load": round(time.time() - t0, 3),
    })

    served = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            reply({"ok": False, "error": f"bad request json: {e}"})
            continue
        tag = {"id": req["id"]} if "id" in req else {}
        if req.get("cmd") == "quit":
            reply({**tag, "ok": True, "quit": True})
            break
        if "fastq" not in req:
            reply({**tag, "ok": False, "error": "missing 'fastq'"})
            continue
        kwargs = {**defaults}
        kwargs.update({k: req[k] for k in _REQ_KEYS if k in req})
        stats = {} if req.get("search_stats") else None
        try:
            with contextlib.redirect_stdout(sys.stderr):
                if "fastq2" in req:
                    # paired-end request: R1 = fastq, R2 = fastq2
                    from deepreadmapper_tpu.pipeline.search import (
                        run_pipeline_paired,
                    )

                    # derive from _REQ_KEYS (a hand-copied list drifted
                    # once already — read_group was dropped here); only the
                    # keys run_pipeline_paired has no parameter for are
                    # excluded
                    pkw = {
                        kk: vv for kk, vv in kwargs.items()
                        if kk in set(_REQ_KEYS) - {"use_dynamic"}
                    }
                    for kk in ("max_isize", "min_isize", "rescue"):
                        if kk in req:
                            pkw[kk] = req[kk]
                    res = run_pipeline_paired(
                        index_prefix, req["fastq"], req["fastq2"], ref_file,
                        vectorizer=vectorizer, search_cfg=search_cfg,
                        preloaded=(engine, config), **pkw,
                    )
                else:
                    res = run_pipeline(
                        index_prefix, req["fastq"], ref_file,
                        vectorizer=vectorizer, search_cfg=search_cfg,
                        preloaded=(engine, config), search_stats=stats,
                        **kwargs,
                    )
            served += 1
            resp = {
                **tag,
                "ok": True,
                "num_queries": res["num_queries"],
                "t_embed": round(res["t_embed"], 3),
                "t_search": round(res["t_search"], 3),
                "t_post": round(res["t_post"], 3),
            }
            if stats:
                # search-effort counters (IVF engines): nprobe tuning data
                resp["search_stats"] = stats
            reply(resp)
        except Exception as e:  # daemon survives a bad request
            reply({**tag, "ok": False, "error": f"{type(e).__name__}: {e}"})
    return served
