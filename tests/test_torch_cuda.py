"""repro_torch's hand-written CUDA kernels on the card.

Every test here is marked ``cuda``: it needs a CUDA device and ``nvcc``
and skips without them (decided when the test runs).  This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA
toolkit::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same
tensors on the card, at the reference's tolerances (1e-4 for the GEMM
and the tile update, 1e-6 for the halo stencil, 2e-5 for flash decode,
rtol 1e-5 / atol 1e-3 for Black-Scholes, 2e-5 in f32 and 2e-2 in bf16
for flash attention), and the machine code of the tensor-core kernels
is read for their ``HGMMA``, ``UTMALDG`` and tf32 ``HMMA`` instructions
(the GEMM and the tile update both);
the app tests drive the wave backend end to end and check that the
registered kernels launched (and, on the sharded executor, that they do
not under a mesh, where every group falls back as ``sharded_mesh``), the serving tests drive the host executor
on the card, and the LLM test counts one flash-attention launch per layer
in one ``generate``; the MoE tests run a reduced DeepSeek-V2-Lite and
Granite-3.0-1B-A400M ``generate`` on the card and hold their logits
against the CPU's plain path in bf16; the VLM test serves a reduced
Qwen2-VL with its vision stub on the card (one flash launch a layer,
the CPU run's tokens in f32), and the flash kernel is held against its
plain version at Qwen2-VL-72B's prefill shape (group 8).  The recurrent
families serve a reduced Zamba2 (its shared attention block through the
flash kernel, one launch a call site) and a reduced xLSTM (no kernel) on
the card, the CPU run's tokens in f32, and the flash kernel is held
against its plain version at Zamba2-1.2B's prefill shape (D 64, group
1).  The encoder-decoder family serves a reduced whisper on the card
(the flash kernel on its encoder, its causal self-attention and its
cross-attention, the CPU run's tokens in f32), and the flash kernel is
held against its plain version at whisper-tiny's encoder (non-causal
1,280 x 1,280) and cross-attention (224 queries over 1,280 frames)
shapes.  The pipeline
test runs ``pipeline_step`` on 4 logical devices of the card against
autograd over the stages in sequence.  The fuzz tests replay a few seeds of the
differential corpus on the card under the sharded dependence managers
(both pumps), with ``_gemm``'s groups on the GEMM kernel at 8x8x8.
The sharded-executor tests run the apps with no mesh, on
``single_device_mesh`` and on 4 logical devices of the card, the
reference's 2-device gemm program on logical devices, and the same
program across two cards (skipped below two CUDA devices).  The training
tests hold the training path (chunked attention, chunked CE, both remat
policies) against the plain one in f32, and a resumed training run
against the straight one, bit for bit, under deterministic algorithms.
The mesh tests serve a reduced Granite on a (2, 2) mesh of 4 logical
devices of the card (the flash kernel once per layer and mesh position,
on each position's contiguous (batch, head) chunk; decode through
``_decode_sp`` over the striped cache, never gathered), held against
the CPU's run with no mesh in f32, and ``_decode_sp`` alone on the card
against the CPU at a stripe boundary, at S - 1 and at S.
"""
import pytest
import torch

from repro_torch import (RuntimeConfig, TaskRuntime, apps, configs,
                         fuzz_graphs, serve_lm, task)
from repro_torch.kernels import _build
from repro_torch.kernels.black_scholes import kernel as bs_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.jacobi import kernel as jac_kernel
from repro_torch.kernels.matmul import kernel as mm_kernel
from repro_torch import dist
from repro_torch.launch import serve as llm_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api, attention, moe
from test_torch_moe_routes import RouteReplay


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
                                      (120, 128, 128, 128), (16, 32, 64, 64),
                                      (2, 64, 36, 250), (6, 8, 8, 8)])
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
@pytest.mark.parametrize("which", ["a", "b", "c"])
def test_cuda_matmul_takes_unaligned_views(cuda_device, which):
    """A contiguous view 4 bytes past a 16-byte boundary runs the 4-byte
    copies and scalar accesses of c and out."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    shapes = {"a": (4, 64, 64), "b": (4, 64, 64), "c": (4, 64, 64)}
    xs = {}
    for name, shape in shapes.items():
        numel = shape[0] * shape[1] * shape[2]
        flat = torch.randn(numel + 1, generator=g, device=cuda_device)
        xs[name] = (flat[1:] if name == which else flat[:-1]).view(shape)
    assert xs[which].data_ptr() % 16 == 4
    got = mm_kernel.matmul_batched(xs["a"], xs["b"], xs["c"])
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, mm_kernel.matmul_batched_plain(xs["a"], xs["b"], xs["c"]),
        rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,nn", [(120, 128, 128, 128), (5, 33, 70, 65),
                                      (2, 130, 200, 96), (3, 64, 36, 250)])
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


# ---------------------------------------------------------------------------
# flash decode and Black-Scholes
@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 1, 1, 512, 128),          # the serve path's per-task shape
    (1, 1, 1, 200, 128),          # S not a multiple of 32
    (3, 6, 2, 77, 64),            # G = 3, ragged S
    (2, 8, 2, 1000, 32),
    (1, 32, 8, 4096, 128),        # Mistral-NeMo-12B's GQA width
    (1, 1, 1, 1, 128),            # S = 1: one key, fifteen empty blocks
    (2, 2, 1, 33, 128),           # fewer keys than blocks x a stage
    (2, 16, 2, 300, 64),          # G = 8 at D 64
    (8, 32, 8, 8192, 128),        # B x Hkv = 64 clusters at S 8,192
])
def test_cuda_flash_decode_matches_plain(cuda_device, b, hq, hkv, s, d):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((b, hq, d), generator=g, device=cuda_device)
    k, v = (torch.randn((b, hkv, s, d), generator=g, device=cuda_device)
            for _ in range(2))
    before = fd_kernel.flash_decode.launches
    o, lse = fd_kernel.flash_decode(q, k, v, bk=s)
    torch.cuda.synchronize()
    assert fd_kernel.flash_decode.launches == before + 1
    wo, wl = fd_kernel.flash_decode_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(o, wo, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, wl, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 1, 1, 512, 128),          # the serve path's per-task shape
    (3, 6, 2, 77, 64),            # G = 3, ragged S
    (2, 8, 2, 1000, 32),
    (1, 1, 1, 1, 128),            # S = 1
    (2, 16, 2, 300, 64),          # G = 8 at D 64
    (4, 32, 8, 4096, 128),        # Mistral-NeMo-12B's GQA width
])
def test_cuda_flash_decode_bf16_kv_matches_plain(cuda_device, b, hq, hkv, s,
                                                 d):
    """K and V in bf16, q in f32: the kernel converts each element to f32
    where it uses it, as the plain version upcasts, so the two differ by
    the order of their f32 sums only."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((b, hq, d), generator=g, device=cuda_device)
    k, v = (torch.randn((b, hkv, s, d), generator=g,
                        device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    before = fd_kernel.flash_decode.launches
    o, lse = fd_kernel.flash_decode(q, k, v, bk=s)
    torch.cuda.synchronize()
    assert fd_kernel.flash_decode.launches == before + 1
    assert o.dtype == lse.dtype == torch.float32
    wo, wl = fd_kernel.flash_decode_plain(q, k, v, d ** -0.5)
    torch.testing.assert_close(o, wo, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, wl, rtol=2e-5, atol=2e-5)
    smem32, _ = fd_kernel.occupancy(hq // hkv, d)
    smem16, resident = fd_kernel.occupancy(hq // hkv, d, torch.bfloat16)
    assert smem16 < smem32 and resident >= 1


@pytest.mark.cuda
def test_cuda_flash_decode_serve_shape_is_one_launch(cuda_device):
    """The serve path's per-task call (q 1x1x128 against one 512-row KV
    tile) launches one kernel, split over a 16-block cluster of 32 keys a
    block, which the card can hold."""
    from torch.autograd import DeviceType
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q = torch.randn((1, 1, 128), generator=g, device=cuda_device)
    k, v = (torch.randn((1, 1, 512, 128), generator=g, device=cuda_device)
            for _ in range(2))
    fd_kernel.flash_decode(q, k, v)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = fd_kernel.flash_decode.launches
    with torch.profiler.profile(activities=acts) as prof:
        fd_kernel.flash_decode(q, k, v)
        torch.cuda.synchronize()
    assert fd_kernel.flash_decode.launches == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "flash_decode" in kernels[0], kernels
    assert fd_kernel.split(512) == (16, 32)
    assert fd_kernel.occupancy(1, 128)[1] >= 1


@pytest.mark.cuda
def test_cuda_flash_decode_refuses_a_split_that_leaves_keys_out(cuda_device):
    """The wrapper passes the keys per block (``split``) to the kernel,
    whose entry refuses a range that would leave keys out."""
    q = torch.zeros((1, 1, 128), device=cuda_device)
    k = torch.zeros((1, 1, 512, 128), device=cuda_device)
    o, lse = torch.empty_like(q), torch.empty((1, 1), device=cuda_device)
    lib = fd_kernel._lib()

    def call(keys_per_block):
        return lib.bddt_flash_decode(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 1, 1, 1, 512, 128, keys_per_block, 1.0,
            _build.stream_handle(q.device))

    cs, keys = fd_kernel.split(512)
    assert call(keys) == 0
    assert call(keys - 1) != 0 and (keys - 1) * cs < 512
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (1001, 0),
                                      (2048, 1), ((1 << 20) + 3, 0)])
def test_cuda_black_scholes_matches_plain(cuda_device, n, offset):
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def col(lo, hi):
        x = torch.rand(n + offset, generator=g, device=cuda_device)
        return (lo + (hi - lo) * x)[offset:]   # offset 1: not 16-B aligned

    xs = [col(10, 200), col(10, 200), col(0.1, 2.0),
          torch.full((n,), 0.03, device=cuda_device), col(0.1, 0.6)]
    before = bs_kernel.black_scholes.launches
    call, put = bs_kernel.black_scholes(*xs)
    torch.cuda.synchronize()
    assert bs_kernel.black_scholes.launches == before + 1
    wc, wp = bs_kernel.black_scholes_plain(*xs)
    torch.testing.assert_close(call, wc, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(put, wp, rtol=1e-5, atol=1e-3)
    parity = call - put - (xs[0] - xs[1] * torch.exp(-xs[3] * xs[2]))
    assert parity.abs().max().item() < 1e-2 * xs[0].abs().max().item()


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 2, 64, device=cuda_device)
    k = torch.zeros(1, 1, 64, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(q, k.mT.contiguous().mT, k)  # not contiguous
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(q, k, k.cpu())               # mixed devices
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(q, k.half(), k.half())       # f16 K/V
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(q, k.bfloat16(), k)          # K, V differ
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(q.bfloat16(), k.bfloat16(), k.bfloat16())
    from repro_torch.kernels.flash_decode import ops as fd_ops
    with pytest.raises(NotImplementedError, match="mask"):
        fd_ops.decode_partial(q, k.bfloat16(), k.bfloat16(),
                              mask=torch.ones((1, 64), dtype=torch.bool,
                                              device=cuda_device))
    with pytest.raises(ValueError, match="head dim"):
        fd_kernel.flash_decode(torch.zeros(1, 1, 96, device=cuda_device),
                               torch.zeros(1, 1, 8, 96, device=cuda_device),
                               torch.zeros(1, 1, 8, 96, device=cuda_device))
    flat = torch.zeros(1 + 2 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        fd_kernel.flash_decode(flat[1:65].view(1, 1, 64),
                               flat[1:].view(1, 1, 2, 64),
                               flat[1:].view(1, 1, 2, 64))
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError):
        bs_kernel.black_scholes(x, x, x, x, x.double())
    with pytest.raises(ValueError):
        bs_kernel.black_scholes(x, x, x, x, x.cpu())
    y = torch.ones(8, 2, device=cuda_device)[:, 0]
    with pytest.raises(ValueError):
        bs_kernel.black_scholes(y, y, y, y, y)               # strided


@task(in_="a", out="c")
def _record_stream(a, c=None):
    _record_stream.seen.append(
        (torch.cuda.current_stream(a.device).cuda_stream,
         torch.cuda.default_stream(a.device).cuda_stream))
    return a + 1.0


_record_stream.seen = []


@pytest.mark.cuda
def test_cuda_host_workers_launch_on_the_default_stream(cuda_device):
    _record_stream.seen.clear()
    with TaskRuntime(RuntimeConfig(executor="host", n_workers=4,
                                   device="cuda")) as rt:
        A = rt.zeros((64, 8), (4, 8))
        C = rt.zeros((64, 8), (4, 8))
        for i in range(16):
            _record_stream(A[i, 0], C[i, 0])
        rt.barrier()
        assert torch.equal(C.gather(), torch.ones(64, 8, device=cuda_device))
    assert len(_record_stream.seen) == 16
    assert all(cur == default for cur, default in _record_stream.seen)


@pytest.mark.cuda
@pytest.mark.parametrize("executor,launches", [("staged", 1), ("host", 16)])
def test_cuda_black_scholes_app_launches_its_kernel(cuda_device, executor,
                                                    launches):
    before = bs_kernel.black_scholes.launches
    apps.run_app("black_scholes", executor=executor, device="cuda",
                 app_kwargs=dict(n_options=8192, task_options=512))
    assert bs_kernel.black_scholes.launches - before == launches


@pytest.mark.cuda
def test_cuda_serve_lm_on_the_host_executor(cuda_device):
    sizes = dict(s_tile=512, d=128, n_tiles=16, shards=4, requests=12,
                 budget=3, workers=4)
    before = fd_kernel.flash_decode.launches
    r = serve_lm.run(RuntimeConfig(executor="host", device="cuda"), **sizes)
    assert fd_kernel.flash_decode.launches - before == 12 * 4
    assert r["rows_verified"] == 12 and r["restore_identical"]
    st = r["stats"]
    assert st.admission_peak_bytes <= st.admission_budget_bytes


# ---------------------------------------------------------------------------
# flash attention and the served dense LLM path
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bq,bk", [
    (2, 4, 4, 128, 128, 64, True, 256, 256),
    (2, 8, 2, 128, 128, 64, True, 256, 256),
    (2, 8, 2, 128, 128, 64, False, 256, 256),
    (1, 2, 2, 32, 128, 64, True, 256, 256),     # prefill continuation
    (1, 2, 2, 64, 48, 32, True, 32, 16),        # rows seeing no key
    (1, 2, 2, 64, 48, 32, True, 16, 16),
    (2, 12, 2, 64, 64, 32, True, 256, 256),     # group 6
    (2, 32, 8, 256, 256, 128, True, 256, 256),
    (1, 4, 2, 100, 164, 128, True, 256, 256),   # ragged Sq and Skv
    (1, 2, 2, 96, 40, 64, True, 32, 8),         # rows seeing no key, D 64
    (1, 2, 2, 96, 40, 128, True, 16, 8),        # ... and D 128
    (1, 6, 1, 50, 70, 128, True, 256, 256),     # group 6, ragged
    (2, 3, 3, 130, 130, 32, False, 256, 256),   # full, ragged, D 32
    (1, 16, 2, 40, 72, 128, True, 256, 256),    # group 8, ragged
    (1, 6, 6, 224, 1280, 64, False, 256, 256),  # whisper cross, half tile
    (1, 6, 6, 1280, 1280, 64, False, 256, 256),  # whisper encoder
])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, b, hq, hkv,
                                            sq, skv, d, causal, bq, bk):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        got.float(), fa_kernel.flash_attention_plain(
            q, k, v, causal=causal, bq=bq, bk=bk).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "bf16_wgmma"),
                                          (torch.float32, "f32_ffma")])
def test_cuda_flash_attention_dispatches_by_dtype(cuda_device, dtype,
                                                  kernel):
    """A bf16 call runs the wgmma kernel and never the FFMA one; f32 the
    reverse."""
    x = torch.randn(1, 4, 64, 64, device=cuda_device).to(dtype)
    before = dict(fa_kernel.flash_attention.launches_by_kernel)
    fa_kernel.flash_attention(x, x, x)
    torch.cuda.synchronize()
    after = fa_kernel.flash_attention.launches_by_kernel
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == kernel) for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("source", sorted(_build.TENSOR_CORE_SASS))
def test_cuda_kernels_use_the_tensor_cores(cuda_device, source):
    """The built machine code: wgmma (HGMMA) fed by TMA (UTMALDG) in the
    bf16 flash-attention kernel, tf32 tensor-core products in the GEMM and
    the tile update."""
    for function, patterns in _build.TENSOR_CORE_SASS[source].items():
        counts = _build.sass_counts(source, function, patterns)
        assert all(n > 0 for n in counts.values()), (function, counts)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_grad_and_mixed_devices(cuda_device):
    x = torch.zeros(1, 2, 16, 32, device=cuda_device, requires_grad=True)
    y = torch.zeros(1, 2, 16, 32, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_kernel.flash_attention(x, y, y)
    with pytest.raises(ValueError, match="mixed"):
        fa_kernel.flash_attention(y, y.cpu(), y)
    with pytest.raises(ValueError, match="dtype|float16|expected"):
        fa_kernel.flash_attention(y.half(), y.half(), y.half())
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 16, 48, device=cuda_device)
        fa_kernel.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 16, 2, 32, device=cuda_device).transpose(1, 2)
        fa_kernel.flash_attention(t, t, t)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_generate_launches_once_per_layer(cuda_device, compute_dtype):
    """One ``generate`` at a reduced config: prefill launches the kernel
    once per layer and decode never; the tokens equal the CPU run's in
    f32 on the same weights."""
    cfg = configs.get_config("mistral-nemo-12b").reduced(
        attn_impl="pallas", compute_dtype=compute_dtype)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    kw = dict(max_new_tokens=4, max_len=64 + 4 + 8)
    on_cpu = llm_serve.generate(cfg, params, {"tokens": tokens}, **kw)
    params = params.to(cuda_device)
    fa_kernel.flash_attention.launches = 0
    out = llm_serve.generate(cfg, params, {"tokens": tokens.to(cuda_device)},
                             **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == cfg.n_layers
    assert tuple(out.shape) == (2, 4) and out.device.type == "cuda"
    if compute_dtype == "float32":
        assert torch.equal(out.cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [("deepseek-v2-lite-16b", "chunked"),
                                       ("granite-moe-1b-a400m", "pallas")])
def test_cuda_moe_generate_matches_the_cpu_run(cuda_device, arch, impl,
                                               monkeypatch):
    """A reduced MoE model in bf16 compute: ``generate`` on the card
    (Granite's prefill launches the flash kernel once per layer, decode
    never; DeepSeek's MLA stays chunked and launches nothing), then the
    prefill and decode logits of the same tokens held against the CPU's
    plain path within 5e-2, the CPU run's expert choices replayed on the
    card (``tests/test_torch_moe_routes.py``: a flip is allowed only at a near-tie
    of two gates)."""
    cfg = configs.get_config(arch).reduced(attn_impl=impl,
                                           compute_dtype="bfloat16")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    kw = dict(max_new_tokens=4, max_len=64 + 4 + 8)
    on_cpu = llm_serve.generate(cfg, params, {"tokens": tokens}, **kw)

    def steps(p, device):
        """Prefill logits and the decode logits of the CPU's tokens."""
        with torch.inference_mode():
            logits, caches = api.prefill_step(
                p, cfg, {"tokens": tokens.to(device)})
            got = [logits.float().cpu()]
            caches = api.pad_caches(caches, kw["max_len"])
            for i in range(on_cpu.shape[1]):
                logits, caches = api.decode_step(
                    p, cfg, on_cpu[:, i:i + 1].to(device), caches, 64 + i)
                got.append(logits.float().cpu())
        return got

    routes, inner = RouteReplay(exact=False), moe._router
    monkeypatch.setattr(moe, "_router", routes.recording(inner))
    want = steps(params, "cpu")
    monkeypatch.setattr(moe, "_router", inner)
    params.to(cuda_device)                          # in place
    fa_kernel.flash_attention.launches = 0
    out = llm_serve.generate(cfg, params,
                             {"tokens": tokens.to(cuda_device)}, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == \
        (cfg.n_layers if impl == "pallas" else 0)
    assert tuple(out.shape) == (2, 4) and out.device.type == "cuda"
    monkeypatch.setattr(moe, "_router", routes.replaying(inner))
    got = steps(params, cuda_device)
    routes.done()
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=5e-2, atol=5e-2,
                                   msg=f"{arch} step {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 17, 25, 41])
def test_cuda_fuzz_seeds_under_sharded_managers(cuda_device, seed):
    """Every path of the fuzz harness on the card: central and sharded
    (sync, threaded) bit-identical, the rest within
    ``fuzz_graphs.CARD_TOL`` (1e-4, the GEMM kernel's) of the sequential
    oracle; then the kernel path under the threaded pump against
    central, launch for launch."""
    assert fuzz_graphs.CARD_TOL == 1e-4
    fuzz_graphs.compare_paths(seed, str(cuda_device))
    runs = {}
    for dm, pump in (("central", "auto"), ("sharded", "threaded")):
        before = mm_kernel.matmul_batched.launches
        out, st = fuzz_graphs.run_case(seed, str(cuda_device),
                                       kernel_backend="pallas",
                                       dep_manager=dm, dep_pump=pump)
        runs[dm] = (out, st, mm_kernel.matmul_batched.launches - before)
    (c_out, c_st, c_n), (s_out, s_st, s_n) = runs["central"], \
        runs["sharded"]
    assert c_n == s_n == c_st.kernel_dispatches == s_st.kernel_dispatches > 0
    for name in c_out:
        assert (c_out[name] == s_out[name]).all(), name
    assert (c_st.deps_found, c_st.blocks_walked) == \
        (s_st.deps_found, s_st.blocks_walked)


@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["staged", "host"])
@pytest.mark.parametrize("pump", ["sync", "threaded"])
def test_cuda_apps_run_under_sharded_managers(cuda_device, executor, pump):
    backend = "pallas" if executor == "staged" else "xla"
    for name, kwargs in (("matmul", dict(n=256, tile=64)),
                         ("cholesky", dict(n=512, tile=128))):
        stats = apps.run_app(name, executor, device=str(cuda_device),
                             kernel_backend=backend, dep_manager="sharded",
                             dep_pump=pump, app_kwargs=kwargs)
        assert stats.dep_messages > 0
        assert sum(stats.manager_admissions) >= stats.tasks_spawned


# ---------------------------------------------------------------------------
# the sharded executor: no mesh, one-device mesh, logical devices, cards
SHARDED_SIZES = {
    "black_scholes": dict(n_options=8192, task_options=512),
    "matmul": dict(n=256, tile=64),
    "fft": dict(n=128, row_block=32, tile=32),
    "jacobi": dict(n=512, tile=128, iters=2),
    "cholesky": dict(n=512, tile=128),
}


def _sharded_mesh(mode, device):
    from repro_torch import dist
    if mode == "mesh1":
        return dist.single_device_mesh(device=device)
    return dist.Mesh(dist.logical_devices(4, device), ("data",))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "mesh1", "mesh4"])
@pytest.mark.parametrize("name", sorted(SHARDED_SIZES))
def test_cuda_sharded_apps_in_three_modes(cuda_device, name, mode):
    """The apps on the sharded executor with the wave backend: with no
    mesh the staged path (wave kernels launched), under a mesh every
    group a ``sharded_mesh`` fallback, no wave kernel, nothing staged,
    each tile on its home device, Black-Scholes once per device."""
    import contextlib
    from repro_torch import dist
    from repro_torch.core.placement import device_assignment
    from repro_torch.obs import InMemoryTracker
    wrappers = {"matmul": mm_kernel.matmul_batched,
                "cholesky": mm_kernel.tile_update_batched,
                "jacobi": jac_kernel.jacobi_halo_batched}
    mesh = None if mode == "none" else _sharded_mesh(mode, cuda_device)
    trk = InMemoryTracker()
    before = {k: w.launches for k, w in wrappers.items()}
    bs_before = bs_kernel.black_scholes.launches
    with dist.use_mesh(mesh) if mesh is not None \
            else contextlib.nullcontext() as ctx:
        rt = TaskRuntime(RuntimeConfig(
            executor="sharded", kernel_backend="pallas",
            device=str(cuda_device), placement="striped", n_controllers=4,
            tracker=trk))
        try:
            apps.APPS[name](rt, **SHARDED_SIZES[name])    # self-verifies
            torch.cuda.synchronize()
            if mesh is not None:
                devmap = device_assignment(4, ctx)
                for ba in rt._arrays:
                    for idx, h in ba.home.items():
                        assert ba.tile_device(idx) == devmap[h % 4]
        finally:
            rt.shutdown()
    st = rt.stats()
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    bs = bs_kernel.black_scholes.launches - bs_before
    reasons = {e.data["reason"] for e in trk.events_of("kernel_dispatch")
               if e.data["backend"] != "pallas"}
    assert st.cross_home_bytes + st.local_home_bytes > 0
    if mode == "none":
        assert st.sharded_dispatches == 0
        assert "sharded_mesh" not in reasons
        if name in wrappers:
            assert launched[name] == st.kernel_dispatches > 0
    else:
        assert st.kernel_dispatches == 0 and reasons == {"sharded_mesh"}
        assert not any(launched.values())
        assert st.bytes_staged == 0
        if mode == "mesh1":
            assert st.tile_moves == 0
            assert st.sharded_dispatches == st.grouped_dispatches > 0
    assert bs == ({"none": 1, "mesh1": 1, "mesh4": 4}[mode]
                  if name == "black_scholes" else 0)


def _sharded_gemm(mesh, device, homes):
    from repro_torch import dist
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(128, 128, generator=gen), \
        torch.randn(128, 128, generator=gen)

    @task(inout="c", in_=("x", "y"))
    def gemm(c, x, y):
        return c + x @ y

    def prog(rt):
        with rt.scope():
            A = rt.from_array(a, (32, 32))
            B = rt.from_array(b, (32, 32))
            C = rt.zeros((128, 128), (32, 32))
            for i in range(4):
                for j in range(4):
                    for k in range(4):
                        gemm(C[i, j], A[i, k], B[k, j])
            rt.barrier()
            st = rt.stats()              # before the read-back's moves
            return C.gather().cpu(), st, (A, B, C)

    seq, _, _ = prog(TaskRuntime(RuntimeConfig(executor="sequential",
                                               device=device)))
    with dist.use_mesh(mesh):
        got, st, arrays = prog(TaskRuntime(RuntimeConfig(
            executor="sharded", placement="striped", n_controllers=homes,
            device=device)))
    return seq, got, st, arrays


@pytest.mark.cuda
def test_cuda_sharded_gemm_on_logical_devices(cuda_device):
    """The reference's 2-device residency program on two logical devices
    of the card: moves measured equal to the footprint prediction."""
    from repro_torch import dist
    mesh = dist.Mesh(dist.logical_devices(2, cuda_device), ("data",))
    seq, got, st, _ = _sharded_gemm(mesh, str(cuda_device), 2)
    assert torch.equal(got, seq)
    g, block_bytes = 4, 32 * 32 * 4
    assert st.sharded_dispatches == 4 and st.bytes_staged == 0
    assert st.bytes_moved == st.cross_home_bytes == \
        g ** 3 // 2 * block_bytes
    assert st.tile_moves == g ** 3 // 2


@pytest.mark.cuda
def test_cuda_sharded_gemm_across_cards(cuda_device):
    """A real multi-GPU mesh: tiles live on the card serving their home,
    each device chunk runs on its own card, and the result and counts
    are the logical-device run's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("data",))
    seq, got, st, arrays = _sharded_gemm(mesh, "cuda:0", 2)
    torch.testing.assert_close(got, seq, rtol=1e-4, atol=1e-4)
    for ba in arrays:
        for idx, h in ba.home.items():
            tile = ba.get_tile(idx)
            assert ba.tile_device(idx).id == h % 2
            assert tile.device == torch.device("cuda", h % 2)
    g, block_bytes = 4, 32 * 32 * 4
    assert st.bytes_moved == st.cross_home_bytes == \
        g ** 3 // 2 * block_bytes
    assert st.bytes_staged == 0


# ---------------------------------------------------------------------------
# the training path on the card
def _plain_loss(params, cfg, tokens):
    """One logsumexp over the full-sequence f32 logits; the reference's
    labels (shifted, the last 0) and mask (the last position out)."""
    logits = api.forward_logits(params, cfg, {"tokens": tokens}).float()
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    mask = torch.ones(tokens.shape, device=tokens.device)
    mask[:, -1] = 0.0
    nll = torch.logsumexp(logits, -1) - \
        logits.gather(-1, labels[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum()


@pytest.mark.cuda
def test_cuda_training_path_matches_the_plain_path(cuda_device):
    """f32, TF32 off: the loss through chunked attention, the chunked CE
    and remat ``full`` and ``dots`` against naive attention, full logits
    and no remat; the loss within 1e-5 relative and every gradient leaf
    within 1e-5 + 1e-4 * max|g| (the same sums in other orders; the CPU
    parity tests' rule)."""
    import dataclasses
    base = configs.get_config("mistral-nemo-12b").reduced(
        n_layers=2, d_model=512, head_dim=128, d_ff=1024, vocab_size=4096)
    params = api.init_params(torch.Generator(device=cuda_device)
                             .manual_seed(0), base,
                             device=cuda_device).requires_grad_(True)
    tokens = torch.randint(0, base.vocab_size, (2, 256), dtype=torch.int32,
                           device=cuda_device, generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    results = {}
    for name, cfg in (
            ("plain", dataclasses.replace(base, attn_impl="naive",
                                          remat=False)),
            ("full", dataclasses.replace(base, remat_policy="full")),
            ("dots", dataclasses.replace(base, remat_policy="dots"))):
        params.zero_grad(set_to_none=True)
        loss = _plain_loss(params, cfg, tokens) if name == "plain" else \
            api.loss_fn(params, cfg, {"tokens": tokens})
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.clone() for n, p in
                                       params.named_parameters()})
    want_loss, want = results["plain"]
    for name in ("full", "dots"):
        loss, grads = results[name]
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), name
        for n, g in grads.items():
            tol = 1e-5 + 1e-4 * want[n].abs().max().item()
            assert (g - want[n]).abs().max().item() <= tol, (name, n)


@pytest.mark.cuda
def test_cuda_train_resume_is_bitwise_under_deterministic_algorithms(
        cuda_device, tmp_path, monkeypatch):
    """Stop at step 6, checkpoint, resume to 12 == the straight run to 12,
    bit for bit, on the card."""
    from repro_torch.launch import train
    from repro_torch.models.transformer import tree_leaves
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = configs.get_config("qwen1.5-4b").reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512)
    kw = dict(seq_len=32, global_batch=4, log_every=1000, peak_lr=1e-3,
              device=cuda_device)
    torch.use_deterministic_algorithms(True)
    try:
        p_a, o_a, _ = train.train_loop(cfg, steps=12, **kw)
        ck = str(tmp_path / "ck")
        train.train_loop(cfg, steps=6, ckpt_dir=ck, ckpt_every=1000, **kw)
        p_b, o_b, _ = train.train_loop(cfg, steps=12, ckpt_dir=ck,
                                       ckpt_every=1000, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(o_a.step) == int(o_b.step) == 12
    for a, b in zip(list(p_a.parameters()) + tree_leaves(o_a.mu) +
                    tree_leaves(o_a.nu),
                    list(p_b.parameters()) + tree_leaves(o_b.mu) +
                    tree_leaves(o_b.nu)):
        assert a.device.type == "cuda" and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the VLM family and the pipeline schedule
@pytest.mark.cuda
def test_cuda_flash_attention_at_the_qwen2_vl_prefill_shape(cuda_device):
    """Qwen2-VL-72B's prefill, B 4 x 1,024, Hq 64, Hkv 8, D 128, bf16,
    causal: group 8, so a block holds 8 positions of each of 8 heads;
    every row, the causal limits at each block's edge included, within
    the bf16 tolerance of the plain version, in one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               .to(torch.bfloat16)
               for s in ((4, 64, 1024, 128), (4, 8, 1024, 128),
                         (4, 8, 1024, 128)))
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), fa_kernel.flash_attention_plain(q, k, v,
                                                     causal=True).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_flash_attention_at_the_zamba2_prefill_shape(cuda_device):
    """Zamba2-1.2B's shared attention block at prefill, B 4 x 1,024, Hq =
    Hkv = 32, D 64, bf16, causal: group 1, so a block holds 64 positions
    of one head; within the bf16 tolerance of the plain version, in one
    launch."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn((4, 32, 1024, 64), generator=g,
                           device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), fa_kernel.flash_attention_plain(q, k, v,
                                                     causal=True).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides", [
    ("zamba2-1.2b", dict(attn_impl="pallas")),
    ("xlstm-1.3b", dict(slstm_every=2))])
def test_cuda_recurrent_generate_matches_the_cpu_run(cuda_device, arch,
                                                      overrides):
    """A reduced Zamba2 (12 Mamba2 layers, the shared block before layer
    6 through the flash kernel) and a reduced xLSTM (2 mLSTM and 2 sLSTM
    layers) in f32 compute: ``generate`` on the card launches the flash
    kernel once per shared call site in prefill and never in decode
    (xLSTM never), and its tokens equal the CPU run's on the same
    weights."""
    from repro_torch.models import transformer
    cfg = configs.get_config(arch).reduced(**overrides)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    kw = dict(max_new_tokens=4, max_len=64 + 4 + 8)
    on_cpu = llm_serve.generate(cfg, params, {"tokens": tokens}, **kw)
    params = params.to(cuda_device)
    fa_kernel.flash_attention.launches = 0
    out = llm_serve.generate(cfg, params, {"tokens": tokens.to(cuda_device)},
                             **kw)
    torch.cuda.synchronize()
    want = len(transformer._zamba_attn_positions(cfg)) \
        if cfg.family == "hybrid" else 0
    assert fa_kernel.flash_attention.launches == want
    assert tuple(out.shape) == (2, 4) and out.device.type == "cuda"
    assert torch.equal(out.cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1280, 224])
def test_cuda_flash_attention_at_the_whisper_shapes(cuda_device, sq):
    """whisper-tiny at 1,280 frames, B 16, Hq = Hkv = 6, D 64, bf16,
    non-causal: the encoder's self-attention (Sq 1,280) and the
    decoder's cross-attention (224 queries over the 1,280 frames, whose
    last 64-row query tile is half full); within the bf16 tolerance of
    the plain version, in one launch."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device)
               .to(torch.bfloat16)
               for s in ((16, 6, sq, 64), (16, 6, 1280, 64),
                         (16, 6, 1280, 64)))
    before = fa_kernel.flash_attention.launches
    got = fa_kernel.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), fa_kernel.flash_attention_plain(q, k, v,
                                                     causal=False).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_whisper_generate_launches_three_times_a_layer(cuda_device):
    """A reduced whisper (2 encoder, 4 decoder layers, 64 frames) in f32
    compute under ``attn_impl="pallas"``: prefill launches the kernel
    once per encoder layer and twice per decoder layer (causal
    self-attention, cross-attention), 10 in all, decode never; the
    tokens equal the CPU run's on the same weights and frames."""
    cfg = configs.get_config("whisper-tiny").reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     dtype=torch.int32, generator=g),
             "enc_frames": torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                       generator=g)}
    kw = dict(max_new_tokens=4, max_len=32 + 4 + 8)
    on_cpu = llm_serve.generate(cfg, params, batch, **kw)
    params = params.to(cuda_device)
    fa_kernel.flash_attention.launches = 0
    out = llm_serve.generate(
        cfg, params, {k: v.to(cuda_device) for k, v in batch.items()}, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == \
        cfg.encoder_layers + 2 * cfg.n_layers == 10
    assert torch.equal(out.cpu(), on_cpu)


@pytest.mark.cuda
def test_cuda_vlm_generate_launches_once_per_layer(cuda_device):
    """A reduced Qwen2-VL with a vision stub, in f32 compute: prefill
    launches the kernel once per layer, decode never, and the tokens
    equal the CPU run's on the same weights and stub."""
    cfg = configs.get_config("qwen2-vl-72b").reduced(attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64),
                                     dtype=torch.int32, generator=g),
             "vision_embeds": torch.randn(2, cfg.vision_seq, cfg.d_model,
                                          generator=g)}
    kw = dict(max_new_tokens=4, max_len=64 + 4 + 8)
    on_cpu = llm_serve.generate(cfg, params, batch, **kw)
    params = params.to(cuda_device)
    fa_kernel.flash_attention.launches = 0
    out = llm_serve.generate(
        cfg, params, {k: v.to(cuda_device) for k, v in batch.items()}, **kw)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == cfg.n_layers
    assert torch.equal(out.cpu(), on_cpu)


@pytest.mark.cuda
def test_cuda_pipeline_step_on_logical_devices_matches_autograd(cuda_device):
    """``pipeline_step`` with 4 stages of a reduced Mistral-NeMo block
    (f32, chunked attention) on 4 logical devices of the card, M 4
    microbatches of 64 tokens: 2 (S-1) M hops, the gradient stack on the
    caller's device, within 1e-5 of each leaf's largest against autograd
    over the four blocks in sequence."""
    from repro_torch import dist
    from repro_torch.core.pipeline import pipeline_step
    from repro_torch.models import transformer
    n_s, n_m, t = 4, 4, 64
    cfg = configs.get_config("mistral-nemo-12b").reduced()
    params = transformer.tree(transformer.init_block(
        torch.Generator(device=cuda_device).manual_seed(0), cfg, layers=n_s,
        device=cuda_device))
    micros = torch.randn(n_m, t, cfg.d_model, device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    pos = torch.arange(t, dtype=torch.int32, device=cuda_device)[None]

    def fwd(w, x):
        return transformer.block_apply(w, x[None], cfg, pos)[0][0]

    def bwd(w, x, g):
        # torch.autograd.grad: the chunked attention's checkpoint hooks
        # are outside what torch.func.vjp takes
        wg = transformer.tree_map(lambda a: a.detach().requires_grad_(True),
                                  w)
        xg = x.detach().requires_grad_(True)
        leaves = transformer.tree_leaves(wg)
        with torch.enable_grad():
            gx, *gw = torch.autograd.grad(fwd(wg, xg), [xg] + leaves, g)
        by_leaf = {id(a): u for a, u in zip(leaves, gw)}
        return gx, transformer.tree_map(lambda a: by_leaf[id(a)], wg)

    pipeline_step.hops = 0
    dw = pipeline_step(fwd, bwd, params, micros,
                       mesh=dist.Mesh(dist.logical_devices(n_s, cuda_device),
                                      ("stage",)),
                       stage_axis="stage", n_stages=n_s)
    assert pipeline_step.hops == 2 * (n_s - 1) * n_m
    seq = transformer.tree_map(lambda a: a.detach().requires_grad_(True),
                               params)
    for m in range(n_m):
        h = micros[m]
        for s in range(n_s):
            h = fwd(transformer.tree_map(lambda a: a[s], seq), h)
        h.sum().backward()
    for got, want in zip(transformer.tree_leaves(dw),
                         transformer.tree_leaves(seq)):
        assert got.device == cuda_device
        err = (got - want.grad).abs().amax(dim=tuple(range(1, got.ndim)))
        top = want.grad.abs().amax(dim=tuple(range(1, got.ndim)))
        assert (err <= 1e-5 * top).all(), (err, top)


def _mesh_2x2(device):
    return make_mesh((2, 2), ("data", "model"),
                     dist.logical_devices(4, device))


@pytest.mark.cuda
def test_cuda_mesh_serving_launches_per_position_and_matches_the_cpu(
        cuda_device):
    """A reduced Granite (f32, ``attn_impl="pallas"``) placed by ``tp`` on
    a (2, 2) mesh of 4 logical devices of the card: prefill launches the
    flash kernel once per layer and mesh position, decode runs
    ``_decode_sp`` over the striped cache with nothing gathered, and the
    prefill and 4 decode steps' logits are within 1e-3 of the CPU's with
    no mesh (the f32 FFMA kernel against the plain version, the stripes'
    merge against one softmax)."""
    cfg = configs.get_config("granite-moe-1b-a400m").reduced(
        attn_impl="pallas")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    nxt = torch.randint(0, cfg.vocab_size, (4, 4), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2))

    def steps(p, device):
        with torch.inference_mode():
            logits, caches = api.prefill_step(
                p, cfg, {"tokens": tokens.to(device)})
            got = [logits.cpu()]
            caches = api.pad_caches(caches, 64 + 8)
            for i in range(nxt.shape[1]):
                logits, caches = api.decode_step(
                    p, cfg, nxt[:, i:i + 1].to(device), caches, 64 + i)
                got.append(logits.cpu())
        return got, caches

    want, _ = steps(params, "cpu")
    params.to(cuda_device)
    with dist.use_mesh(_mesh_2x2(cuda_device)) as ctx:
        placed = dist.device_put(params, dist.sharding.param_shardings(
            cfg, params, ctx, policy="tp"))
        p = api.prepare(placed, cfg)
        fa_kernel.flash_attention.launches = 0
        gathered = dist.gather.copied_bytes
        got, caches = steps(p, cuda_device)
        torch.cuda.synchronize()
        assert fa_kernel.flash_attention.launches == cfg.n_layers * 4
        assert dist.gather.copied_bytes == gathered
    assert all(isinstance(x, dist.Placed)
               for x in dist.placed_leaves(caches)) and \
        caches["moe"]["k"].shards[ctx.mesh.devices.flat[0]].is_cuda
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [32, 63, 64])
def test_cuda_decode_sp_matches_the_cpu(cuda_device, pos):
    """``_decode_sp`` over a 64-row cache striped on the (2, 2) mesh of
    the card against the same on the CPU's logical devices: a stripe
    boundary, the last row, and one past it (no stripe writes)."""
    cfg = configs.get_config("granite-moe-1b-a400m").reduced()
    g = torch.Generator().manual_seed(5)
    shapes = ((4, cfg.n_heads, 1, cfg.head_dim),
              (4, cfg.n_kv_heads, 1, cfg.head_dim),
              (4, cfg.n_kv_heads, 1, cfg.head_dim),
              (4, cfg.n_kv_heads, 64, cfg.head_dim),
              (4, cfg.n_kv_heads, 64, cfg.head_dim))
    q, kn, vn, kc, vc = (torch.randn(s, generator=g) for s in shapes)
    out = {}
    for device in ("cpu", cuda_device):
        with dist.use_mesh(_mesh_2x2(device)) as ctx:
            cache = api.place_caches(cfg, {"k": kc.to(device),
                                           "v": vc.to(device)})
            o, cache = attention._decode_sp(
                *(t.to(device) for t in (q, kn, vn)), cache, pos, cfg, ctx)
            out[str(device)] = [o.cpu()] + [dist.gather(cache[n]).cpu()
                                            for n in ("k", "v")]
    for a, b in zip(out[str(cuda_device)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
