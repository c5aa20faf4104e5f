"""The plain reference: NumPy and PyTorch only, nothing of the program
under test.  It works out the P2 nodes, the periodic identification, the
operator, the loads, the fields and the homogenized tensor again from
the benchmark's own inputs, and judges the program's outputs by them."""

import torch

# full float32 products wherever the reference runs in float32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
