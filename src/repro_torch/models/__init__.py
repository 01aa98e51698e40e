"""Models of the port.  The reference contracts (exact fp32 ``top1``,
exact k-center picks) need IEEE fp32 products, so TF32 is switched off
here, at import: every module of the port that computes imports this
package."""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
