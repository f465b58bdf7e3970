"""Compute ops: CRF recursions, graph/segment ops, the CUDA kernels
(``ops.cuda``, which this package's import neither imports nor builds)."""
from ananke_abm_tpu_torch.ops.crf import (
    crf_log_partition,
    crf_marginals,
    crf_nll,
    crf_path_score,
    viterbi_decode,
    viterbi_decode_no_all_home,
)

__all__ = [
    "crf_log_partition",
    "crf_marginals",
    "crf_nll",
    "crf_path_score",
    "viterbi_decode",
    "viterbi_decode_no_all_home",
]
