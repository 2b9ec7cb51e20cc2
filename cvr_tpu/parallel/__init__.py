from cvr_tpu.parallel.partition import partition_rows_by_nnz
from cvr_tpu.parallel.dist import (
    DistSellMatrix,
    dist_sell_pack,
    dist_spmv,
    make_mesh,
)

__all__ = [
    "partition_rows_by_nnz",
    "DistSellMatrix",
    "dist_sell_pack",
    "dist_spmv",
    "make_mesh",
]
