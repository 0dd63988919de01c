"""mm2-gb-tpu: a long-read mapper with GPU chaining in JAX.

A from-scratch reimplementation of the capabilities of minimap2 v2.24 +
mm2-gb (GPU segmented chaining):

- host layer (NumPy/C++): sequence I/O, minimizer sketching, sorted-array
  minimizer index, chain backtracking, hit post-processing, base-level
  alignment, PAF/SAM output;
- device layer (JAX/Pallas on an NVIDIA GPU): the segmented anchor
  chaining forward DP;
- parallel layer: data-parallel read mapping over several GPUs with
  deterministic output merging.

The byte-level accuracy contract is inherited from mm2-gb: PAF output must
be identical to minimap2 v2.24 run with --max-chain-skip=infinity
(reference README.md "Accuracy evaluation").
"""

__version__ = "0.1.0"

from mm2_gb_tpu.utils.opts import IndexOptions, MapOptions, set_preset

__all__ = [
    "IndexOptions",
    "MapOptions",
    "set_preset",
    "__version__",
]
