"""metaeuk_tpu — a GPU gene-discovery framework.

A from-scratch reimplementation of the capabilities of MetaEuk
(homology-based eukaryotic gene prediction in metagenomic contigs) on
JAX: XLA and a CUDA Smith-Waterman kernel for the device work,
shard_map distribution over device meshes, and a thin host layer for
I/O.

Pipeline (mirrors reference easy-predict, data/easypredict.sh):
  contigs → six-frame stop-to-stop putative protein fragments
          → batched Smith-Waterman search against a protein target DB
          → per-(contig,target,strand) exon-chaining dynamic program
          → redundancy reduction + same-strand overlap resolution
          → FASTA / GFF / TSV outputs (byte-parity with the reference)
          → optional taxonomy assignment (weighted LCA voting)
"""

import os

__version__ = "0.1.0"

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ):
    """Where this package puts JAX's persistent compilation cache: None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then keeps it there on
    its own), else the fixed git-ignored .jax_cache of the checkout."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def _enable_compilation_cache():
    import jax
    cache_dir = compile_cache_dir(os.environ)
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # persist every executable: sub-second compiles add up to tens of
    # seconds of per-process cold start across the pipeline's shapes
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


_enable_compilation_cache()
