"""Whole-genome Average Nucleotide Identity (ANI) engine on JAX accelerators.

A from-scratch reimplementation of the capabilities of ``pyfastani``
(the FastANI method: MashMap-based alignment-free genome mapping) whose
query path -- fragment winnowing and sketching, candidate regions,
sketch intersection and ANI aggregation -- runs as one vectorized
JAX/XLA program over a device mesh (with one Pallas kernel on NVIDIA
GPUs), instead of the reference's C++ pointer-chasing loops.

Public API mirrors the reference contract
(``/root/reference/src/pyfastani/__init__.py:1-27``):

    >>> import pyfastani_tpu as pyfastani
    >>> sketch = pyfastani.Sketch()
    >>> sketch.add_genome("genome1", sequence)
    >>> mapper = sketch.index()
    >>> hits = mapper.query_genome(query_sequence)

References:
    - Jain C, Rodriguez-R LM, Phillippy AM, Konstantinidis KT, Aluru S.
      *High throughput ANI analysis of 90K prokaryotic genomes reveals clear
      species boundaries*. Nat Commun. 2018;9(1):5114.
      doi:10.1038/s41467-018-07641-9.
"""

from ._version import __version__
from .models import (
    Sketch,
    Mapper,
    Hit,
    Minimizers,
    MinimizerInfo,
    MinimizerIndex,
    Position,
    MAX_KMER_SIZE,
)

__author__ = "pyfastani-tpu contributors"
__license__ = "MIT"

__all__ = [
    "Sketch",
    "Mapper",
    "Hit",
    "Minimizers",
    "MinimizerInfo",
    "MinimizerIndex",
    "Position",
    "MAX_KMER_SIZE",
]
