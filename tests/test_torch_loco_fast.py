"""The LoCo backward's kernel interface on the CPU: the bf16 gradient taken
as it is, the error state written in place on cadence, a bf16 shard out.

* (a) The loco and ef codecs' encode of a bf16 gradient equals the
  reference codec's encode of the same values in f32: payload and scales
  bit for bit, the f8 error within one f8 quantum on fewer than 5e-3 of the
  elements (``assert_f8_close``, the tolerance ``tests/test_kernels.py``
  grants the Pallas kernel), the bf16 error bit for bit; and the port's own
  f32 encode bit for bit.
* (b) One ``gather_with_sync`` backward hands ``fused_compress`` the bf16
  gradient itself and the state as its error output, and returns
  ``dequant_mean``'s bf16 shard as the gradient with no cast between; two
  backwards leave the state the out-of-place path leaves, byte for byte.
* (c) With ``every = 2`` the off-cadence step returns a zero shard and folds
  ``g`` into the old state (DESIGN.md section 16), exactly; the on-cadence
  step then writes in place.
* (d) The plain ``dequant_mean``'s bf16 shard is its f32 shard rounded to
  bf16, bit for bit; the exact reciprocal the kernels multiply by is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro_torch.core import codec as tcodec
from repro_torch.core import hijack as thijack
from repro_torch.core import loco as tloco
from repro_torch.interop import to_torch
from repro_torch.kernels import loco_quant as LQ
from repro_torch.launch import mesh as tmesh
from test_torch_codec import _cfgs, _grad, _np, _states, assert_f8_close

N_ELEM = 8 * 512


def _bf16_grad(rng, n):
    """A bf16 gradient (torch) and the same values in f32 (numpy)."""
    g = jnp.asarray(_grad(rng, n)).astype(jnp.bfloat16)
    t = to_torch(np.asarray(g))
    return t, t.float().numpy()


def _bytes(t):
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16)


@pytest.mark.parametrize("strategy,bits", [("loco", 4), ("loco", 8),
                                           ("ef", 4), ("ef", 8)])
def test_bf16_gradient_encode_matches_reference(strategy, bits):
    rng = np.random.default_rng(30 + bits + len(strategy))
    g16, g32 = _bf16_grad(rng, N_ELEM)
    jcfg, tcfg = _cfgs(strategy, bits)
    js, ts = _states(strategy, rng, N_ELEM)
    jwire, jnew = jcodec.get_codec(jcfg).encode_ref(jnp.asarray(g32), js)
    codec = tcodec.get_codec(tcfg)
    twire, tnew = codec.encode(g16, ts)
    for k in ("payload", "scales"):
        np.testing.assert_array_equal(twire[k].numpy(), np.asarray(jwire[k]))
    if strategy == "loco":
        assert_f8_close(tnew, jnew)
    else:
        np.testing.assert_array_equal(_np(tnew), _np(jnew))
    fwire, fnew = codec.encode(torch.from_numpy(g32), ts)
    for k in ("payload", "scales"):
        assert torch.equal(twire[k], fwire[k])
    assert torch.equal(_bytes(tnew), _bytes(fnew))


@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield g


def _spy(monkeypatch):
    """Record fused_compress's arguments and dequant_mean's results."""
    seen = {"compress": [], "decode": []}
    real_fc, real_dm = LQ.fused_compress, LQ.dequant_mean

    def fused_compress(g, e, **kw):
        seen["compress"].append((g, e, kw))
        return real_fc(g, e, **kw)

    def dequant_mean(p, s, **kw):
        out = real_dm(p, s, **kw)
        seen["decode"].append(out)
        return out

    monkeypatch.setattr(LQ, "fused_compress", fused_compress)
    monkeypatch.setattr(LQ, "dequant_mean", dequant_mean)
    return seen


def _backward(group, cfg, state, x, step=None):
    """One backward of sum(gather(w) * x) on a bf16 leaf: returns the
    cotangent that reached the gather and the shard that reached w."""
    w = torch.zeros(x.shape[0], dtype=torch.bfloat16, requires_grad=True)
    got = {}
    w.register_hook(lambda grad: got.__setitem__("shard", grad))
    flat = thijack.gather_with_sync(w, state, cfg, group, step=step)
    flat.register_hook(lambda grad: got.__setitem__("g", grad))
    (flat.float() * x).sum().backward()
    return got["g"], got["shard"]


def test_backward_hands_kernels_bf16_and_writes_state_in_place(
        group1, monkeypatch):
    cfg = tloco.SyncConfig(strategy="loco")
    rng = np.random.default_rng(31)
    xs = [torch.from_numpy(_grad(rng, N_ELEM)) for _ in range(2)]
    # the out-of-place path on the same cotangents, for the state it leaves
    ref_state = tloco.init_state(cfg, N_ELEM)
    real = thijack.dist_sync
    monkeypatch.setattr(thijack, "dist_sync",
                        lambda *a, **k: real(*a, **{**k, "inplace": False}))
    ref_shards = [_backward(group1, cfg, ref_state, x)[1] for x in xs]
    monkeypatch.undo()

    seen = _spy(monkeypatch)
    state = tloco.init_state(cfg, N_ELEM)
    for i, x in enumerate(xs):
        g_full, shard = _backward(group1, cfg, state, x)
        g, e, kw = seen["compress"][i]
        assert g.dtype == torch.bfloat16 and g.data_ptr() == g_full.data_ptr()
        assert e is state and kw["e_out"] is state
        out = seen["decode"][i]
        assert out.dtype == shard.dtype == torch.bfloat16
        assert shard.data_ptr() == out.data_ptr()    # no cast after decode
        assert torch.equal(_bytes(shard), _bytes(ref_shards[i]))
    assert torch.equal(_bytes(state), _bytes(ref_state))
    assert float(state.float().abs().max()) > 0


def test_off_cadence_step_folds_gradient_into_old_state(group1, monkeypatch):
    cfg = tloco.SyncConfig(strategy="loco", every=2)
    codec = tcodec.get_codec(cfg)
    rng = np.random.default_rng(32)
    xs = [torch.from_numpy(_grad(rng, N_ELEM)) for _ in range(2)]
    seen = _spy(monkeypatch)
    state = tloco.init_state(cfg, N_ELEM)

    g0, shard0 = _backward(group1, cfg, state, xs[0], step=0)
    assert seen["compress"][0][2]["e_out"] is None   # old state still read
    assert shard0.dtype == torch.bfloat16 and not shard0.any()
    want = codec.state_encode(g0.float() + codec.state_decode(
        tloco.init_state(cfg, N_ELEM)))
    assert torch.equal(_bytes(state), _bytes(want))

    g1, shard1 = _backward(group1, cfg, state, xs[1], step=1)
    assert seen["compress"][1][2]["e_out"] is state  # on cadence: in place
    wire, want = codec.encode(g1, want)
    want_shard = codec.decode_mean({k: v[None] for k, v in wire.items()},
                                   torch.bfloat16)
    assert torch.equal(_bytes(state), _bytes(want))
    assert torch.equal(_bytes(shard1), _bytes(want_shard))


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_mean_bf16_is_rounded_f32(D, bits):
    rng = np.random.default_rng(40 + D + bits)
    g = torch.from_numpy(_grad(rng, D * 2 * 512))
    e = torch.zeros_like(g).to(torch.float8_e4m3fn)
    p, s, _ = LQ.fused_compress(g, e, bits=bits, beta=0.5, escale=2.0**14)
    p, s = p.reshape(D, -1), s.reshape(D, -1)
    f32 = LQ.dequant_mean(p, s, bits=bits)
    b16 = LQ.dequant_mean(p, s, bits=bits, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
    assert torch.equal(_bytes(b16), _bytes(f32.to(torch.bfloat16)))
    assert torch.equal(f32, LQ.dequant_mean_plain(p, s, bits=bits))


def test_fused_compress_in_place_equals_out_of_place():
    rng = np.random.default_rng(41)
    g16, _ = _bf16_grad(rng, N_ELEM)
    _, e = _states("loco", rng, N_ELEM)
    kw = dict(bits=4, beta=0.5, escale=2.0**14)
    p, s, e_new = LQ.fused_compress(g16, e, **kw)
    e2 = e.clone()
    p2, s2, e_in = LQ.fused_compress(g16, e2, e_out=e2, **kw)
    assert e_in is e2
    assert torch.equal(p, p2) and torch.equal(s, s2)
    assert torch.equal(_bytes(e_new), _bytes(e2))


@pytest.mark.parametrize("x,inv", [(2.0**14, 2.0**-14), (1.0, 1.0),
                                   (4.0, 0.25), (2.0**-126, 2.0**126),
                                   (2.0**127, 0.0), (3.0, 0.0), (6.0, 0.0),
                                   (2.0**-127, 0.0)])
def test_exact_inverse(x, inv):
    assert LQ.exact_inverse(x) == inv
    if inv:  # y / x == y * (1/x) in f32, subnormal results included
        y = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
        y = np.concatenate([y, y * np.float32(2.0**-120), y * 1e30])
        with np.errstate(over="ignore", under="ignore"):
            np.testing.assert_array_equal(y / np.float32(x),
                                          y * np.float32(inv))
