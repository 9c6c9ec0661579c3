"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  This file imports no JAX, so it also runs on a GPU
machine that has none:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the full model's shapes.
"""
import pytest
import torch

from repro_torch.kernels import loco_quant as LQ


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_kernels_match_plain(cuda_device, bits):
    gen = torch.Generator(device=cuda_device).manual_seed(bits)
    n = 64 * 512
    g = torch.randn(n, generator=gen, device=cuda_device) * 1e-3
    cells = [("f8", (torch.randn(n, generator=gen, device=cuda_device) * 200)
              .clamp(-448, 448).to(torch.float8_e4m3fn), 0.5, 2.0**14),
             ("bf16", torch.zeros(n, dtype=torch.bfloat16, device=cuda_device),
              1.0, 1.0)]
    LQ.reset_launches()
    for err, e, beta, escale in cells:
        kw = dict(bits=bits, beta=beta, escale=escale, err=err)
        got = LQ.fused_compress(g, e, **kw)
        want = LQ.fused_compress_plain(g, e, **kw)
        for k, w in zip(got, want):
            assert torch.equal(k.view(torch.uint8) if k.dtype.itemsize == 1
                               else k, w.view(torch.uint8)
                               if w.dtype.itemsize == 1 else w)
        for D in (1, 2, 4, 8):
            p, s = got[0].reshape(D, -1), got[1].reshape(D, -1)
            assert torch.equal(LQ.dequant_mean(p, s, bits=bits),
                               LQ.dequant_mean_plain(p, s, bits=bits))
    assert LQ.LAUNCHES == {"fused_compress": 2, "dequant_mean": 8}


def _bytes(t):
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@pytest.mark.parametrize("n", [64 * 512, 33554432])
def test_cuda_loco_interface_variants(cuda_device, n):
    """bf16 gradient in, error written in place, bf16 shard out: bit-exact
    against the plain versions at a small shape and at the deepseek-v3-moe
    expert shape (33,554,432 elements)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = (torch.randn(n, generator=gen, device=cuda_device) * 1e-3).to(
        torch.bfloat16)
    e = (torch.randn(n, generator=gen, device=cuda_device) * 200).clamp(
        -448, 448).to(torch.float8_e4m3fn)
    kw = dict(bits=4, beta=0.5, escale=2.0**14)
    want = LQ.fused_compress_plain(g, e, **kw)
    LQ.reset_launches()
    assert all(torch.equal(_bytes(k), _bytes(w))
               for k, w in zip(LQ.fused_compress(g.float(), e, **kw), want))
    e_in = e.clone()
    got = LQ.fused_compress(g, e_in, e_out=e_in, **kw)
    assert got[2] is e_in
    assert all(torch.equal(_bytes(k), _bytes(w)) for k, w in zip(got, want))
    for D in (1, 2, 4, 8):
        p, s = got[0].reshape(D, -1), got[1].reshape(D, -1)
        ref = LQ.dequant_mean_plain(p, s)
        out = LQ.dequant_mean(p, s, out_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        assert torch.equal(_bytes(out), _bytes(ref.to(torch.bfloat16)))
        assert torch.equal(LQ.dequant_mean(p, s), ref)
    assert LQ.LAUNCHES == {"fused_compress": 2, "dequant_mean": 8}


def test_cuda_loco_dividing_variants(cuda_device):
    """An error scale that is no power of two and D = 3 peers: the kernels
    divide where the main path multiplies, bit-exact all the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    n = 3 * 64 * 512
    g = (torch.randn(n, generator=gen, device=cuda_device) * 1e-3).to(
        torch.bfloat16)
    e = (torch.randn(n, generator=gen, device=cuda_device) * 200).clamp(
        -448, 448).to(torch.float8_e4m3fn)
    kw = dict(bits=4, beta=0.5, escale=3000.0)
    got = LQ.fused_compress(g, e, **kw)
    want = LQ.fused_compress_plain(g, e, **kw)
    assert all(torch.equal(_bytes(k), _bytes(w)) for k, w in zip(got, want))
    p, s = got[0].reshape(3, -1), got[1].reshape(3, -1)
    ref = LQ.dequant_mean_plain(p, s)
    assert torch.equal(LQ.dequant_mean(p, s), ref)
    assert torch.equal(_bytes(LQ.dequant_mean(p, s, out_dtype=torch.bfloat16)),
                       _bytes(ref.to(torch.bfloat16)))


def _act_rows(gen, dev, rows=64):
    h = torch.randn(rows, 512, generator=gen, device=dev)
    h *= 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 8 - 5)
    h[1] = 0.0
    h[2, 5] = 3.0e38
    h[3] *= 1e-39
    return h


def test_cuda_act_kernels_match_plain(cuda_device):
    from repro_torch.kernels import act_quant as AQ

    h = _act_rows(torch.Generator(device=cuda_device).manual_seed(3),
                  cuda_device)
    AQ.reset_launches()
    q, s = AQ.act_encode(h)
    pq, ps = AQ.act_encode_plain(h)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(AQ.act_decode(q, s), AQ.act_decode_plain(q, s))
    assert AQ.LAUNCHES == {"act_encode": 1, "act_decode": 1}


def test_cuda_onebit_pack_matches_plain(cuda_device):
    from repro_torch.kernels import sign_pack as SP

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    h = torch.randn(64 * 512, generator=gen, device=cuda_device) * 1e-3
    h[::97] = 0.0
    h[1::89] = -0.0
    scale = h.abs().mean()
    SP.reset_launches()
    p, e = SP.onebit_pack(h, scale)
    pp, pe = SP.onebit_pack_plain(h, scale)
    assert torch.equal(p, pp)
    assert torch.equal(e.view(torch.int16), pe.view(torch.int16))
    assert SP.LAUNCHES == {"onebit_pack": 1}


@pytest.mark.parametrize("D", [3, 5, 2])
def test_cuda_fp_mean_is_ieee_division(cuda_device, D):
    """The fp wire's mean over D peers, on the card: the f64 quotient
    rounded to f32 (one IEEE division), also where D is no power of two
    and torch would multiply by 1/D for a Python-scalar divisor."""
    from repro_torch.core.comm import fp_mean

    gen = torch.Generator(device=cuda_device).manual_seed(D)
    summed = (torch.randn(1 << 16, generator=gen, device=cuda_device)
              * 1e-2).to(torch.bfloat16)
    got = fp_mean(summed, D)
    assert got.dtype == torch.float32
    want = (summed.double() / D).float()
    assert torch.equal(got, want)
    if D == 3:   # what the repair avoids: a multiply rounds otherwise
        assert not torch.equal(summed.float() / D, want)


# ---------------------------------------------------------------------------
# the overlapped schedule's pieces and asynchronous collectives
# ---------------------------------------------------------------------------

def test_cuda_compress_in_place_into_piece_view(cuda_device):
    """fused_compress writing its error in place into a column view of a
    run's state (the overlapped schedule's piece at D = 1, non-zero
    ``col_off``) gives the bytes of the whole-run call's slice."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    total, a = 96 * 512, 40 * 512       # piece [a, total) of the run
    g = (torch.randn(total, generator=gen, device=cuda_device) * 1e-3).to(
        torch.bfloat16)
    e = (torch.randn(total, generator=gen, device=cuda_device) * 200).clamp(
        -448, 448).to(torch.float8_e4m3fn)
    for bits in (4, 8):
        kw = dict(bits=bits, beta=0.5, escale=2.0**14)
        whole = LQ.fused_compress(g, e, **kw)
        run = e.clone()
        view = run[a:]
        assert view.data_ptr() % 16 == 0 and view.is_contiguous()
        got = LQ.fused_compress(g[a:], view, e_out=view, **kw)
        assert got[2].data_ptr() == view.data_ptr()
        pb = a // 2 if bits == 4 else a
        assert torch.equal(got[0], whole[0][pb:])
        assert torch.equal(got[1], whole[1][a // 256:])
        assert torch.equal(_bytes(run[a:]), _bytes(whole[2][a:]))
        assert torch.equal(_bytes(run[:a]), _bytes(e[:a]))   # untouched


def test_cuda_overlapped_sync_of_path_d_embedding(cuda_device):
    """chip_smoke.py's path d (llama2-400m, --bucket-mb 4 --policy
    embed=loco8,min=1048576) at dp = 1: the embedding's overlapped sync
    (its loco8 run cut into 16,777,216 + 15,728,640 elements) equals the
    flat one, shard and state, over two rounds."""
    import types

    from repro_torch.core import comm, flatparam, wirepack
    from repro_torch.launch import mesh, steps, train
    from repro_torch.models.transformer import build_groups

    args = train.build_args(["--arch", "llama2-400m", "--bucket-mb", "4",
                             "--policy", "embed=loco8,min=1048576"])
    plan = steps.build_sync_plan(
        train.make_run(args), build_groups(train.make_cfg(args), 1),
        types.SimpleNamespace(dp=1, tp=1)).lookup("embed", "tok")
    sched = wirepack.build_overlap_schedule(plan, 1)
    assert [p.chunk_total for st in sched.stages for p in st.pieces
            if p.sync.strategy == "loco"] == [16777216, 15728640]
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    g = (torch.randn(plan.chunklen, generator=gen, device=cuda_device)
         * 1e-3).to(torch.bfloat16)
    e0 = []
    for unit in flatparam.state_units(plan, True):
        n, dt = flatparam.bucket_state_struct(unit)
        e0.append(torch.zeros(n, device=cuda_device) if dt == torch.float32
                  else (torch.randn(n, generator=gen, device=cuda_device)
                        * 100).clamp(-448, 448).to(dt))
    with mesh.dp_group(cuda_device) as group:
        outs = []
        for overlap in (True, False):
            st = tuple(s.clone() for s in e0)
            for r in range(2):
                sh, st = comm.dist_sync_runs(
                    g * (r + 1), st, plan, group, overlap=overlap,
                    out_dtype=torch.bfloat16, inplace=True)
            outs.append((sh, st))
        torch.cuda.synchronize()
    assert torch.equal(_bytes(outs[0][0]), _bytes(outs[1][0]))
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(_bytes(a), _bytes(b))


def test_cuda_async_exchange_survives_dropped_pack_buffer(cuda_device):
    """An ``async_op`` all-to-all whose pack buffer loses its last Python
    reference before ``wait()``, while the allocator hands out and
    overwrites memory of its size, still delivers the packed bytes, which
    decode to the sender's mean."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    n = 1 << 22
    g = torch.randn(n, generator=gen, device=cuda_device) * 1e-3
    e = torch.zeros(n, dtype=torch.float8_e4m3fn, device=cuda_device)
    payload, scales, _ = LQ.fused_compress(g, e, bits=4, beta=0.5,
                                           escale=2.0**14)
    want = LQ.dequant_mean(payload[None], scales[None])
    with mesh.dp_group(cuda_device) as group:
        packed = torch.cat([payload.view(torch.uint8),
                            scales.view(torch.uint8)])[None]
        out = torch.empty_like(packed)
        work = dist.all_to_all_single(out, packed, group=group,
                                      async_op=True)
        nbytes = packed.numel()
        del packed
        junk = [torch.full((nbytes,), 0xA5, dtype=torch.uint8,
                           device=cuda_device) for _ in range(8)]
        work.wait()
        row = out[0]
        got = LQ.dequant_mean(row[:n // 2].view(torch.int8)[None],
                              row[n // 2:].view(torch.float32)[None])
        torch.cuda.synchronize()
        del junk
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the train step's divisions and the sequence-parallel collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 6])
def test_cuda_step_divide_is_ieee_division(cuda_device, n):
    """The step's one division helper (microbatch means, the dp x tp loss
    divisor, the clip's ``s2 / tp``): on the card, the CPU's IEEE
    division, also where ``n`` is no power of two."""
    from repro_torch.core.comm import divide

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(1 << 16, generator=gen, device=cuda_device)
    got = divide(x, n)
    assert torch.equal(got.cpu(), divide(x.cpu(), n))
    assert torch.equal(got, (x.double() / n).float())
    if n == 3:   # what the repair avoids: a multiply rounds otherwise
        assert not torch.equal(x / n, got)


def test_cuda_grad_mean_over_3_microbatches(cuda_device):
    """``grad / accum`` at accum 3 (``--global-batch 12 --microbatch 4``):
    the card's mean of the accumulated gradients is the CPU's."""
    from repro_torch.core.flatparam import ParamGroup, ParamInfo
    from repro_torch.launch.steps import _grads

    groups = [ParamGroup("block", (ParamInfo("w", (4, 512)),), n_layers=2),
              ParamGroup("embed", (ParamInfo("tok", (8, 512)),))]
    gen = torch.Generator().manual_seed(3)

    def leaves(device):
        out = {}
        for g in groups:
            rows = []
            for _ in range(g.n_layers or 1):
                t = torch.zeros(2048, device=device, requires_grad=True)
                t.grad = torch.randn(2048, generator=gen).to(device)
                rows.append(t)
            out[g.name] = {"w" if g.stacked else "tok":
                           rows if g.stacked else rows[0]}
        return out

    gen.manual_seed(3)
    cpu = _grads(leaves("cpu"), groups, 3)
    gen.manual_seed(3)
    card = _grads(leaves(cuda_device), groups, 3)
    for g in cpu:
        for k in cpu[g]:
            assert torch.equal(card[g][k].cpu(), cpu[g][k]), (g, k)


def test_cuda_sp_collectives_at_world_size_1(cuda_device):
    """``sp_gather`` and ``sp_scatter_sum`` on an NCCL group of one rank:
    forward and backward (their transposes) are the identity, the
    sequence axis moved to the front and back."""
    from repro_torch.launch import mesh
    from repro_torch.models import common as C

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    with mesh.dp_group(cuda_device) as group:
        for fn in (C.sp_gather, C.sp_scatter_sum):
            x = torch.randn(2, 8, 16, generator=gen, device=cuda_device).to(
                torch.bfloat16).requires_grad_()
            w = torch.randn(2, 8, 16, generator=gen, device=cuda_device).to(
                torch.bfloat16)
            y = fn(x, group)
            assert torch.equal(y, x)
            y.backward(w)
            assert torch.equal(x.grad, w)


def test_cuda_optimizer_scalar_divisions_are_ieee(cuda_device):
    """The optimizers divide by a 0-dim scalar filled on the card
    (``optimizers._on``), which gives the CPU's bits; a 0-dim CPU operand,
    which torch on CUDA turns into a multiply by its inverse, does not."""
    from repro_torch.optim import optimizers as OPT

    m = torch.randn(1 << 20, generator=torch.Generator().manual_seed(7))
    bc1, _ = OPT._bias_corrections(torch.tensor(2), 0.9, 0.999)
    mc = m.to(cuda_device)
    assert torch.equal((mc / OPT._on(bc1, mc)).cpu(), m / bc1)
    assert not torch.equal((mc / bc1).cpu(), m / bc1)


@pytest.mark.parametrize("mode", ["block", "fixed", "tensor"])
def test_cuda_codec_metrics_match_cpu(cuda_device, mode):
    """The telemetry hooks run plain torch on the card: the same counts
    as on the CPU, sums within rtol 1e-5, and no kernel launch."""
    from repro_torch.core import codec
    from repro_torch.core.loco import SyncConfig
    from repro_torch.core.quantizer import QuantConfig

    c = codec.get_codec(SyncConfig(quant=QuantConfig(mode=mode)))
    gen = torch.Generator().manual_seed(11)
    g = torch.randn(1 << 16, generator=gen) * 1e-4
    e = c.state_encode(torch.randn(1 << 16, generator=gen) * 2e-2)
    LQ.reset_launches()
    for cpu, card in ((c.grad_metrics(g), c.grad_metrics(g.to(cuda_device))),
                      (c.state_metrics(e),
                       c.state_metrics(e.to(cuda_device)))):
        for k, v in cpu.items():
            if k.endswith(("_cnt", "_tot", "_bad")):
                assert float(card[k]) == float(v), k
            else:
                torch.testing.assert_close(card[k].cpu(), v, rtol=1e-5,
                                           atol=0)
    assert LQ.LAUNCHES == {}


@pytest.mark.parametrize("step", [0, 1, 2])
def test_cuda_adam_update_is_the_cpus(cuda_device, step):
    """One Adam update of a 2^20-element leaf gives the CPU's bits on the
    card: the bias corrections divide on the card (``optimizers._on``),
    as on the CPU, where a 0-dim CPU divisor would multiply by the
    inverse."""
    from repro_torch.optim import optimizers as OPT

    gen = torch.Generator().manual_seed(17 + step)
    p, g = (torch.randn(1 << 20, generator=gen) for _ in range(2))
    m, v = (torch.randn(1 << 20, generator=gen) * 1e-2 for _ in range(2))
    v = v.abs()
    opt = OPT.adam()
    lr = torch.tensor(3e-4)

    def update(dev):
        tree = lambda x: {"g": {"w": x.to(dev)}}   # noqa: E731
        new, (m2, v2) = opt.update(tree(g), (tree(m), tree(v)), tree(p),
                                   torch.tensor(step), lr, {"g": {"w": 1.0}})
        return [t["g"]["w"].cpu() for t in (new, m2, v2)]

    for a, b in zip(update(cuda_device), update(torch.device("cpu"))):
        assert torch.equal(a, b)


def test_cuda_topk_selection_is_the_cpus_on_ties(cuda_device):
    """The top-k codec's stable selection orders equal |h| by index on the
    card as on the CPU (and as ``jax.lax.top_k``): the wire and the error
    state of a gradient made of ties are the CPU's, byte for byte."""
    from repro_torch.core import codec
    from repro_torch.core import wirepack as WP
    from repro_torch.core.loco import SyncConfig

    gen = torch.Generator().manual_seed(5)
    n = 64 * codec.TOPK_SEL
    levels = torch.tensor([0.0, 1e-3, 2e-3, -2e-3])
    g = levels[torch.randint(0, 4, (n,), generator=gen)]
    for frac in (0.01, 0.25):
        c = codec.get_codec(SyncConfig(strategy="topk", topk_frac=frac))
        st = c.init_state(n)
        cw, cs = c.encode(g, st)
        gw, gs = c.encode(g.to(cuda_device), st.to(cuda_device))
        for k in cw:
            assert torch.equal(WP.to_bytes(gw[k]).cpu(), WP.to_bytes(cw[k]))
        assert torch.equal(gs.cpu().view(torch.uint8), cs.view(torch.uint8))
        recv = {k: v[None] for k, v in gw.items()}
        assert torch.equal(c.decode_mean(recv).cpu(),
                           c.decode_mean({k: v[None] for k, v in cw.items()}))


@pytest.mark.parametrize("name", ["classic", "hier4", "three-tier",
                                  "onebit"])
def test_cuda_hierarchical_sync_is_the_cpus(cuda_device, name):
    """``comm.hierarchical_sync`` over size-1 mesh axes on the card gives
    the CPU's shard and state bit for bit (kernels against plain
    versions, through every leg)."""
    import torch.distributed as dist

    from repro_torch.core import comm
    from repro_torch.core.loco import SyncConfig, SyncTier
    from repro_torch.core.quantizer import QuantConfig
    from repro_torch.launch import mesh

    naive = lambda b: SyncConfig(strategy="naive4",   # noqa: E731
                                 quant=QuantConfig(bits=b))
    cfg, k = {
        "classic": (SyncConfig(hierarchical=True), 2),
        "hier4": (SyncConfig(hierarchical=True, stage2=naive(4)), 2),
        "three-tier": (SyncConfig(quant=QuantConfig(bits=8),
                                  hierarchical=True,
                                  tiers=(SyncTier(naive(8)), SyncTier(
                                      SyncConfig(strategy="topk",
                                                 topk_frac=0.25)))), 3),
        "onebit": (SyncConfig(strategy="onebit", hierarchical=True), 2),
    }[name]
    gen = torch.Generator().manual_seed(9)
    n = 256 * 1024
    g = (torch.randn(n, generator=gen) * 1e-3).to(torch.bfloat16)
    st = (torch.randn(n, generator=gen) * 100).clamp(-448, 448).to(
        torch.float8_e4m3fn if name != "onebit" else torch.bfloat16)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        with mesh.dp_group(dev) as world:
            axes = mesh.mesh_axes(world, 1, pods=1, wans=1 if k == 3 else 0)
            shard, new = comm.hierarchical_sync(g.to(dev), st.to(dev), cfg,
                                                axes)
            out[dev.type] = (shard.cpu(), new.cpu())
        assert not dist.is_initialized()
    (a, b), (c, d) = out["cuda"], out["cpu"]
    assert torch.equal(a, c)
    assert torch.equal(_bytes(b), _bytes(d))


# ---------------------------------------------------------------------------
# lamb, adafactor and the clip: the CPU's bits on the card
# ---------------------------------------------------------------------------

def _leaves(x):
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


@pytest.mark.parametrize("step", [0, 1, 2])
@pytest.mark.parametrize("name", ["lamb", "adafactor", "adafactor_flat"])
def test_cuda_optimizer_update_is_the_cpus(cuda_device, name, step):
    """One update of a 2^20-element leaf (1024 x 1024 for the factored
    adafactor) gives the CPU's parameters and state bit for bit: roots are
    correctly rounded (``optimizers._sqrt``), a reciprocal root is one
    divided by the root, and lamb's norms and adafactor's means and RMS
    sum in f64 and round once."""
    from repro_torch.optim import optimizers as OPT

    gen = torch.Generator().manual_seed(23 + step)
    shape = (1024, 1024)
    p, g = (torch.randn(shape, generator=gen) for _ in range(2))
    m = torch.randn(shape, generator=gen) * 1e-2
    v = torch.randn(shape, generator=gen).abs() * 1e-2
    flat = name != "adafactor"

    def tree(x, dev):
        return {"g": {"w": (x.reshape(-1) if flat else x).to(dev)}}

    def update(dev):
        state = {"lamb": lambda: (tree(m, dev), tree(v, dev)),
                 "adafactor_flat": lambda: (tree(v, dev),),
                 "adafactor": lambda: ((v[:, 0].to(dev), v[0].to(dev)),),
                 }[name]()
        new, st = OPT.OPTIMIZERS[name]().update(
            tree(g, dev), state, tree(p, dev), torch.tensor(step),
            torch.tensor(1e-3), {"g": {"w": 1.0}})
        return [t.cpu() for t in _leaves(new) + _leaves(st)]

    for a, b in zip(update(cuda_device), update(torch.device("cpu"))):
        assert torch.equal(a, b)


def test_cuda_grad_norm_and_clip_scale_are_the_cpus(cuda_device):
    """The step's pre-clip norm (``steps.grad_norm``: every leaf's squares
    summed in f64, rounded once, the correctly rounded root) and the clip
    scale (one IEEE division of a device-filled clip norm) over a 2^20-
    element leaf and a stacked one give the CPU's bits; torch's own f32
    norm on the card may not."""
    from repro_torch.core.flatparam import MeshTopo, ParamGroup, ParamInfo
    from repro_torch.launch import mesh, steps
    from repro_torch.optim import optimizers as OPT

    groups = [ParamGroup("a", (ParamInfo("w", (1024, 1024)),)),
              ParamGroup("b", (ParamInfo("w", (4, 512)),), n_layers=3)]
    gen = torch.Generator().manual_seed(29)
    grads = {"a": {"w": torch.randn(1 << 20, generator=gen)},
             "b": {"w": torch.randn(3, 2048, generator=gen) * 1e-3}}
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        tree = {g: {k: t.to(dev) for k, t in sub.items()}
                for g, sub in grads.items()}
        with mesh.dp_group(dev) as world:
            gn = steps.grad_norm(tree, groups, MeshTopo.from_group(world),
                                 dev)
        out[dev.type] = [t.cpu() for t in (
            gn, OPT.clip_scale(gn, 1.0), OPT.clip_scale(gn, 0.37),
            OPT.global_grad_norm(tree))]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert torch.equal(out["cuda"][0], out["cuda"][3])


def test_cuda_probe_reference_stack_is_the_cpus(cuda_device):
    """A probe sync of a full-width llama2-400m tensor's length (the
    embedding's 32,768,000 elements, bf16 gradient, f8 error) on the card:
    the shard, the new state and the reference stack (true mean, live and
    zero-state roundtrips) are the CPU's bit for bit."""
    from repro_torch.core import comm
    from repro_torch.core.loco import SyncConfig
    from repro_torch.launch import mesh

    n = 32_768_000
    gen = torch.Generator().manual_seed(31)
    g = (torch.randn(n, generator=gen) * 1e-3).to(torch.bfloat16)
    st = (torch.randn(n, generator=gen) * 100).clamp(-448, 448).to(
        torch.float8_e4m3fn)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        with mesh.dp_group(dev) as world:
            got = comm.dist_sync(g.to(dev), st.to(dev), SyncConfig(), world,
                                 probe=True)
        out[dev.type] = [t.cpu() for t in got]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == b.dtype and torch.equal(_bytes(a), _bytes(b))
    assert out["cuda"][2].shape == (3, n)
