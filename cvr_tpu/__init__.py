"""cvr_tpu — a JAX sparse linear-algebra framework for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capability set of the CGO'18
CVR artifact (puckbee/CVR):

  * MatrixMarket / SuiteSparse ingestion into COO/CSR   (ref: spmv.cpp:311-535)
  * a vectorization-oriented lane-packed sparse format ("SELL-pack", the
    SELL-C-sigma analogue of CVR's AVX-512 tracker layout, ref:
    spmv.cpp:565-1014) with a streaming, metered CSR->packed converter
  * SpMV / multi-RHS SpMM that keep every lane balanced on power-law
    matrices (ref: spmv.cpp:1016-1667)
  * in-binary golden verification vs a scalar CSR reference
    (ref: spmv.cpp:1843-1938)
  * a benchmark harness reporting pre-processing time, SpMV GFLOPS and nnz/s
    (ref: run_comparison.sh, README.md:47-49)
  * beyond the single-node reference: multi-chip row-partitioned SpMV over a
    jax.sharding.Mesh with collective distribution of the dense vector.

Nothing in this package is a translation of the reference's C++/AVX-512 code;
it re-derives the same *ideas* (nnz balance, pre-packed branch-free streaming,
conversion time as a product metric) for a GPU's hardware gather, its
coalesced row loads, and XLA's static-shape compilation model.
"""

__version__ = "0.1.0"

from cvr_tpu.formats import pack_auto
from cvr_tpu.formats.bell import BellInfeasible, BellMatrix, bell_pack
from cvr_tpu.formats.bsr import BsrInfeasible, BsrMatrix, bsr_pack
from cvr_tpu.formats.coo import COOMatrix
from cvr_tpu.formats.dia import DiaInfeasible, DiaMatrix, dia_pack
from cvr_tpu.formats.csr import CSRMatrix
from cvr_tpu.formats.sell import SellMatrix, sell_pack
from cvr_tpu.io.mmio import read_matrix_market, write_matrix_market
from cvr_tpu.ops.spmv import spmv, spmm
from cvr_tpu.ops.spmv_ref import spmv_csr_jnp, spmv_golden_numpy

__all__ = [
    "BellInfeasible",
    "BellMatrix",
    "bell_pack",
    "BsrInfeasible",
    "BsrMatrix",
    "bsr_pack",
    "COOMatrix",
    "CSRMatrix",
    "DiaInfeasible",
    "DiaMatrix",
    "dia_pack",
    "SellMatrix",
    "sell_pack",
    "pack_auto",
    "read_matrix_market",
    "write_matrix_market",
    "spmv",
    "spmm",
    "spmv_csr_jnp",
    "spmv_golden_numpy",
]
