"""The hand-written Hopper SSD kernel against its plain PyTorch version, on
the card. Marked ``gpu``: skipped where no CUDA device is present. Run on the
card with ``python -m pytest tests/test_torch_cuda.py``."""
import pytest
import torch

from hnet_mamba_asr_torch.ops.ssd import ssd_chunked
from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda

pytestmark = pytest.mark.gpu

# max|y - y_plain| / max|y_plain|: fp32 differs in summation order only; bf16
# inputs are held to the fp32 result on the same rounded inputs, and the
# kernel rounds its output to bf16 once more
BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, B, L, H, P, N, G, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, L, H, P, generator=g).to(cuda, dtype),
            (torch.rand(B, L, H, generator=g) * 0.2 + 0.001).to(cuda),
            (-(torch.rand(H, generator=g) * 15 + 1)).to(cuda),
            torch.randn(B, L, G, N, generator=g).to(cuda, dtype),
            torch.randn(B, L, G, N, generator=g).to(cuda, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 37, 4, 64, 128, 2), (3, 130, 12, 64, 128, 1),
                                   (2, 873, 16, 64, 128, 4), (1, 1, 12, 64, 128, 1)])
def test_kernel_matches_plain(cuda, dtype, shape):
    Bsz, L, H, P, N, G = shape
    x, dt, A, B, C = _inputs(cuda, *shape, dtype)
    s0 = torch.randn(Bsz, H, N, P, device=cuda)
    before = ssd_cuda.launches
    y, s = ssd_cuda(x, dt, A, B, C, initial_state=s0, return_final=True)
    y_p, s_p = ssd_chunked(x.float(), dt, A, B.float(), C.float(), chunk_size=64,
                           initial_state=s0, return_final=True)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    rel = ((y.float() - y_p).abs().max() / y_p.abs().max()).item()
    rel_s = ((s - s_p).abs().max() / s_p.abs().max()).item()
    assert rel <= BOUND[dtype] and rel_s <= BOUND[dtype], (rel, rel_s)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C = _inputs(cuda, 1, 8, 2, 16, 16, 1, torch.float32)
    with pytest.raises(ValueError, match="not built"):
        ssd_cuda(x, dt, A, B, C)                          # only P 64, N 128 is built
    x, dt, A, B, C = _inputs(cuda, 1, 8, 2, 64, 128, 1, torch.float32)
    with pytest.raises(TypeError):
        ssd_cuda(x.half(), dt, A, B.half(), C.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C)
