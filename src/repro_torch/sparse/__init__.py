from repro_torch.sparse.tensor import SparseTensor, from_dense
from repro_torch.sparse import baselines, synthetic
from repro_torch.sparse.io import read_tns, write_tns

__all__ = ["SparseTensor", "from_dense", "baselines", "synthetic",
           "read_tns", "write_tns"]
