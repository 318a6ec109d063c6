"""repro_torch's hand-written CUDA kernels on the card.

Every test here is marked ``cuda``: it needs a CUDA device and ``nvcc``
and skips without them (decided when the test runs).  This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
tensors on the card, at the reference's tolerances (1e-4 for the GEMM
and the tile update, 1e-6 for the halo stencil); the app tests drive the
wave backend end to end and check that the registered kernels launched.
"""
import pytest
import torch

from repro_torch import RuntimeConfig, TaskRuntime, apps
from repro_torch.kernels import _build
from repro_torch.kernels.jacobi import kernel as jac_kernel
from repro_torch.kernels.matmul import kernel as mm_kernel


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if _build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,nn", [(256, 64, 64, 64), (3, 70, 33, 129),
                                      (120, 128, 128, 128)])
def test_cuda_matmul_matches_plain(cuda_device, n, m, k, nn):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a, b, c = (torch.randn(s, generator=g, device=cuda_device)
               for s in ((n, m, k), (n, k, nn), (n, m, nn)))
    before = mm_kernel.matmul_batched.launches
    got = mm_kernel.matmul_batched(a, b, c)
    torch.cuda.synchronize()
    assert mm_kernel.matmul_batched.launches == before + 1
    torch.testing.assert_close(got, mm_kernel.matmul_batched_plain(a, b, c),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,nn", [(120, 128, 128, 128), (5, 33, 70, 65)])
def test_cuda_tile_update_matches_plain(cuda_device, n, m, k, nn):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    c, a, b = (torch.randn(s, generator=g, device=cuda_device)
               for s in ((n, m, nn), (n, m, k), (n, nn, k)))
    before = mm_kernel.tile_update_batched.launches
    got = mm_kernel.tile_update_batched(c, a, b)
    torch.cuda.synchronize()
    assert mm_kernel.tile_update_batched.launches == before + 1
    torch.testing.assert_close(
        got, mm_kernel.tile_update_batched_plain(c, a, b),
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,tile,offsets", [
    (1536, 1536, 512, [(512, 512)] * 4),
    (1024, 1536, 512, [(0, 512), (512, 512), (0, 0)]),
    (48, 40, 16, [(0, 0), (32, 24), (16, 8), (99, -5)]),
])
def test_cuda_jacobi_halo_matches_plain(cuda_device, h, w, tile, offsets):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    halo = torch.randn((len(offsets), h, w), generator=g, device=cuda_device)
    r0 = torch.tensor([o[0] for o in offsets], device=cuda_device)
    c0 = torch.tensor([o[1] for o in offsets], device=cuda_device)
    got = jac_kernel.jacobi_halo_batched(halo, r0, c0, (tile, tile))
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, jac_kernel.jacobi_halo_batched_plain(halo, r0, c0, (tile, tile)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(2, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        mm_kernel.matmul_batched(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):
        mm_kernel.matmul_batched(x.mT, x, x)         # not contiguous
    with pytest.raises(ValueError):
        mm_kernel.matmul_batched(x, x, x.cpu())      # mixed devices


@pytest.mark.cuda
@pytest.mark.parametrize("name,kwargs,wrapper", [
    ("matmul", dict(n=256, tile=64), mm_kernel.matmul_batched),
    ("cholesky", dict(n=512, tile=128), mm_kernel.tile_update_batched),
    ("jacobi", dict(n=1024, tile=256, iters=2),
     jac_kernel.jacobi_halo_batched),
])
def test_cuda_apps_launch_their_wave_kernels(cuda_device, name, kwargs,
                                             wrapper):
    before = wrapper.launches
    stats = apps.run_app(name, executor="staged", kernel_backend="pallas",
                         device="cuda", app_kwargs=kwargs)   # self-verifies
    assert stats.kernel_dispatches > 0
    assert wrapper.launches - before == stats.kernel_dispatches


@pytest.mark.cuda
def test_cuda_sequential_and_staged_kernels_agree(cuda_device):
    outs = {}
    for executor, backend in (("sequential", "xla"), ("staged", "pallas")):
        with TaskRuntime(RuntimeConfig(executor=executor,
                                       kernel_backend=backend,
                                       device="cuda")) as rt:
            outs[executor] = apps.matmul_app(rt, n=256, tile=64).gather()
    torch.testing.assert_close(outs["staged"], outs["sequential"],
                               rtol=2e-4, atol=2e-4)
