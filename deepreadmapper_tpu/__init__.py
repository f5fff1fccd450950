"""deepreadmapper_tpu — a JAX DNA read-mapping framework for the GPU.

JAX/XLA/Pallas implementation of the embed -> ANN -> rerank read
mapping method of DeepReadMapper (reference: hunglongtrangithub/DeepReadMapper,
a C++17/OpenVINO/FAISS CPU pipeline).  Reads and reference-genome windows
(forward + reverse complement) are embedded into 128-dim vectors by a 2-layer
bidirectional GRU encoder, candidate mapping locations are found by nearest
neighbor search (exact tiled-matmul oracle, exhaustive PQ/ADC scan, or HNSW
batched beam search), and candidates are reranked by exact L2 or a
Smith-Waterman wavefront kernel, emitting indices.npy/distances.npy and SAM.

Layer map:
  io/        host data layer: FASTA/FASTQ/TXT parsing, windowing + revcomp,
             npy/SAM/config.txt writers (reference: src/utils/parse_inputs.cpp,
             src/utils/utils.cpp)
  tokenizer  vectorized 3-mer tokenizer with exact parity to the reference
             (reference: src/inference/preprocess.cpp, src/utils/tok2index.cpp)
  models/    bi-GRU encoder as a jitted JAX model + weight loading from the
             shipped OpenVINO IR (reference: src/inference/*, models/*)
  ops/       device compute: exact top-k distance matmuls, PQ train/encode/ADC,
             Smith-Waterman wavefront, the windowed int8 scan
             (Pallas/Triton kernel + plain XLA version)
  index/     ANN index engines: flat (exact oracle), pq_flat (exhaustive ADC),
             hnsw (graph build + batched beam search)
             (reference: src/hnswpq/, src/hnswm/, src/gann_hnsw/)
  pipeline/  end-to-end build & search pipelines + post-processing / rerank
             (reference: src/main.cpp, src/utils/post_processor.cpp)
  parallel/  multi-card: device mesh, sharded index search with all-gather
             top-k merge, data-parallel embedding, sharded fine-tune step
"""

__version__ = "0.1.0"

from deepreadmapper_tpu.config import (  # noqa: F401
    BuildConfig,
    InferenceConfig,
    SearchConfig,
)
