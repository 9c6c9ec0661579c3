"""The port's top-k codec and ragged wire leaves against the JAX reference
(CPU).

``TopKCodec`` keeps, per 512-element block of the compensated gradient,
the ``topk_k`` largest-|h| entries as capacity-padded (u16 index, bf16
value) slots with a u32 live count.  Held here: the encode's wire byte for
byte and its f8 error state within one f8 quantum on fewer than 5e-3 of
the elements (the codec standard of ``tests/test_torch_codec.py``), over
random gradients and over gradients built of ties (equal ``|h|`` must
select the lower index first, as ``jax.lax.top_k`` does); ``topk_frac=1``
as the dense bf16 wire; the receiver's mean; the byte accounting; the
ragged pack -> unpack, which zeroes whatever crossed in the dead slots,
packed and per leaf (``exchange_wire`` on a one-rank group); and the
coalesced group plan of a top-k bucket.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import loco as jloco
from repro.core import quantizer as jQ
from repro.core import wirepack as JWP
from repro.telemetry import wire as JW
from repro_torch.core import codec as tcodec
from repro_torch.core import comm as tcomm
from repro_torch.core import loco as tloco
from repro_torch.core import quantizer as tQ
from repro_torch.core import wirepack as TWP
from repro_torch.interop import to_torch
from repro_torch.launch import mesh as tmesh
from repro_torch.telemetry import wire as TW
from test_torch_codec import _f8_state, _grad, _np, assert_f8_close
from test_torch_wirepack import LOCO4, make_plan

SEL = tcodec.TOPK_SEL


def _cfgs(frac, **kw):
    return (jloco.SyncConfig(strategy="topk", topk_frac=frac, **kw),
            tloco.SyncConfig(strategy="topk", topk_frac=frac, **kw))


TOPK = _cfgs(0.05)


def _tie_grad(rng, n):
    """A gradient of ties: each block draws from four magnitudes and both
    signs, with runs of zeros, so most of a block's top-k choices are
    between equal |h|."""
    levels = np.float32([0.0, 1e-3, 2e-3, 2e-3 + 2.0**-20])
    g = rng.choice(levels, n) * rng.choice(np.float32([-1, 1]), n)
    g.reshape(-1, SEL)[::3, :200] = 0.0
    return g.astype(np.float32)


def _encode_both(cfgs, g, state):
    jc, tc = (jcodec.get_codec(cfgs[0]), tcodec.get_codec(cfgs[1]))
    jw, js = jc.encode(jnp.asarray(g), state[0])
    tw, ts = tc.encode(torch.from_numpy(g), state[1])
    return (jw, js), (tw, ts)


def _assert_wire_equal(tw, jw):
    assert tw.keys() == jw.keys()
    for k in jw:
        want = np.asarray(jw[k])
        got = tw[k]
        assert TWP.dtype_name(got.dtype) == want.dtype.name, k
        assert TWP.to_bytes(got).numpy().tobytes() == want.tobytes(), k


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.25, 1.0])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_topk_encode_matches_reference(frac, ties):
    rng = np.random.default_rng(int(frac * 100) + 7 * ties)
    n = 8 * SEL
    g = _tie_grad(rng, n) if ties else _grad(rng, n)
    if ties:
        st = (jnp.zeros(n, jnp.float8_e4m3fn),
              torch.zeros(n, dtype=torch.float8_e4m3fn))
    else:
        st = _f8_state(rng, n, spread=20.0)
    cfgs = _cfgs(frac)
    (jw, js), (tw, ts) = _encode_both(cfgs, g, st)
    _assert_wire_equal(tw, jw)
    assert_f8_close(ts, js)
    k = tcodec.topk_k(cfgs[1])
    if ties and k < SEL:   # the cut fell between equal |h| in some block
        a = -np.sort(-np.abs(g.reshape(-1, SEL)), axis=1)
        assert ((a[:, k - 1] == a[:, k]) & (a[:, k] > 0)).any()


def test_topk_select_orders_ties_like_lax_top_k():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, (16, SEL)).astype(np.float32)
    for k in (1, 5, 128, SEL):
        jv, ji = jax.lax.top_k(jnp.asarray(a), k)
        tv, ti = tcodec.topk_select(torch.from_numpy(a), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_topk_dense_is_the_bf16_wire():
    """``topk_frac=1`` keeps every nonzero entry: the decode of one node's
    wire is its gradient rounded to bf16, as in the reference."""
    rng = np.random.default_rng(11)
    n = 4 * SEL
    g = _grad(rng, n)
    cfgs = _cfgs(1.0)
    assert tcodec.topk_cap(cfgs[1]) == SEL
    (jw, _), (tw, ts) = _encode_both(
        cfgs, g, (jnp.zeros(n, jnp.float8_e4m3fn),
                  torch.zeros(n, dtype=torch.float8_e4m3fn)))
    _assert_wire_equal(tw, jw)
    d = tcodec.get_codec(cfgs[1]).decode_mean({k: v[None]
                                               for k, v in tw.items()})
    np.testing.assert_array_equal(
        d.numpy(), torch.from_numpy(g).to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jcodec.get_codec(cfgs[0]).decode_mean(
            {k: v[None] for k, v in jw.items()})))


@pytest.mark.parametrize("D", [1, 2])
def test_topk_decode_mean_matches_reference(D):
    rng = np.random.default_rng(20 + D)
    n = 4 * SEL
    cfgs = TOPK
    jws, tws = [], []
    for _ in range(D):
        (jw, _), (tw, _) = _encode_both(cfgs, _grad(rng, n),
                                        _f8_state(rng, n, spread=20.0))
        jws.append(jw)
        tws.append(tw)
    jrecv = {k: jnp.stack([w[k] for w in jws]) for k in jws[0]}
    trecv = {k: torch.stack([w[k] for w in tws]) for k in tws[0]}
    np.testing.assert_array_equal(
        tcodec.get_codec(cfgs[1]).decode_mean(trecv).numpy(),
        np.asarray(jcodec.get_codec(cfgs[0]).decode_mean(jrecv)))


def test_topk_sim_sync_matches_reference():
    """Two simulated nodes over two rounds whose error state evolves."""
    rng = np.random.default_rng(31)
    N, n = 2, 2 * SEL
    g = np.stack([_grad(rng, n) for _ in range(N)])
    jcfg, tcfg = TOPK
    jst, tst = jloco.sim_init(jcfg, N, n), tloco.sim_init(tcfg, N, n)
    for step in (1, 2):
        jg, jst = jloco.sim_sync(jnp.asarray(g), jst, jnp.int32(step), jcfg)
        tg, tst = tloco.sim_sync(torch.from_numpy(g), tst, step, tcfg)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert_f8_close(tst, jst)
        tst = to_torch(np.asarray(jst))


def test_topk_wire_shapes_and_byte_accounting():
    """The wire leaves, and the capacity, scale and count-aware effective
    bytes, equal the reference's; ``topk_frac=1`` has effective ==
    capacity, and a dense codec is unchanged."""
    n = 8 * SEL
    for frac in (0.01, 0.05, 0.3, 1.0):
        jcfg, tcfg = _cfgs(frac)
        js = jcodec.get_codec(jcfg).wire_shapes(n)
        ts = tcodec.get_codec(tcfg).wire_shapes(n)
        assert js.keys() == ts.keys()
        for k in js:
            assert (ts[k].shape, ts[k].comm, ts[k].count_of,
                    ts[k].ragged, ts[k].nbytes) == (
                js[k].shape, js[k].comm, js[k].count_of, js[k].ragged,
                js[k].nbytes)
            assert TWP.dtype_name(ts[k].dtype) == jnp.dtype(js[k].dtype).name
        assert (tcodec.topk_k(tcfg), tcodec.topk_cap(tcfg)) == (
            jcodec.topk_k(jcfg), jcodec.topk_cap(jcfg))
        for fn in ("payload_bytes", "scale_bytes", "effective_wire_bytes",
                   "state_bytes"):
            assert getattr(TW, fn)(n, tcfg) == getattr(JW, fn)(n, jcfg), fn
    u = n // SEL
    cfg = TOPK[1]
    k, cap = tcodec.topk_k(cfg), tcodec.topk_cap(cfg)
    assert TW.payload_bytes(n, cfg) == u * cap * 4
    assert TW.scale_bytes(n, cfg) == u * 4
    assert TW.effective_wire_bytes(n, cfg) == u * (4 + 4 * k)
    full = _cfgs(1.0)[1]
    assert TW.effective_wire_bytes(n, full) == (
        TW.payload_bytes(n, full) + TW.scale_bytes(n, full))


def _garbage_wires():
    """A four-block top-k wire (slot 0, counts 0 / 1 / mid / full, garbage
    in the dead slots) and a loco wire (slot 1) of 4 x 512 elements, on
    both sides."""
    cfg = TOPK[1]
    k, cap = tcodec.topk_k(cfg), tcodec.topk_cap(cfg)
    u = D = 4
    rng = np.random.default_rng(0)
    counts = np.uint32([0, 1, k // 2, k])
    idx = rng.integers(0, SEL, (u, cap)).astype(np.uint16)
    val = rng.standard_normal((u, cap)).astype(np.float32)
    dead = np.arange(cap)[None, :] >= counts.astype(np.int64)[:, None]
    idx[dead] = 0x1FF
    val[dead] = 999.0
    g = (rng.standard_normal(D * SEL) * 1e-3).astype(np.float32)
    jl, _ = jcodec.get_codec(LOCO4[0]).encode(
        jnp.asarray(g), jnp.zeros(D * SEL, jnp.float8_e4m3fn))
    tl, _ = tcodec.get_codec(LOCO4[1]).encode(
        torch.from_numpy(g), torch.zeros(D * SEL,
                                         dtype=torch.float8_e4m3fn))
    jv = jnp.asarray(val).astype(jnp.bfloat16)
    jw = {0: {"cnt": jnp.asarray(counts), "idx": jnp.asarray(idx).reshape(-1),
              "val": jv.reshape(-1)}, 1: jl}
    tw = {0: {"cnt": to_torch(counts), "idx": to_torch(idx).reshape(-1),
              "val": to_torch(np.asarray(jv)).reshape(-1)}, 1: tl}
    return jw, tw, dead


def test_ragged_pack_unpack_masks_dead_slots():
    """pack -> unpack of a ragged leaf pair beside a dense bucket: live
    slots round-trip, dead slots come back zero whatever crossed, and the
    result is the reference's byte for byte."""
    D = 4
    jg = JWP.build_group_plan(make_plan((TOPK, LOCO4), 0, D=D), D, pods=1)
    tg = TWP.build_group_plan(make_plan((TOPK, LOCO4), 1, D=D), D)
    ja, ta = jg.group("flat", "a2a"), tg.group("flat", "a2a")
    assert [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype,
             l.count_of) for l in ta.leaves] == [
        (l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype, l.count_of)
        for l in ja.leaves]
    jw, tw, dead = _garbage_wires()
    tbuf = TWP.pack_a2a(ta, tw)
    jbuf = JWP.pack_a2a(ja, jw)
    assert tbuf.numpy().tobytes() == np.asarray(jbuf).tobytes()
    jb, tb = JWP.unpack_a2a(ja, jbuf), TWP.unpack_a2a(ta, tbuf)
    for slot in jb:
        for name, want in jb[slot].items():
            got = tb[slot][name]
            assert TWP.to_bytes(got).numpy().tobytes() == \
                np.asarray(want).tobytes(), (slot, name)
    cap = tcodec.topk_cap(TOPK[1])
    idx = tb[0]["idx"].view(torch.int16).numpy().reshape(-1, cap)
    assert (idx[dead] == 0).all() and (idx[~dead] != 0).any()
    assert (_np(tb[0]["val"]).reshape(-1, cap)[dead] == 0).all()


def test_mask_by_count_matches_reference():
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((3, 4 * 8)).astype(np.float32)
    cnt = rng.integers(0, 9, (3, 4)).astype(np.uint32)
    want = JWP.mask_by_count(jnp.asarray(arr), jnp.asarray(cnt))
    got = TWP.mask_by_count(torch.from_numpy(arr), to_torch(cnt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exchange_wire_masks_dead_slots():
    """The per-leaf exchange (one-rank group) masks on receipt too: the
    decode of a wire with garbage in its dead slots equals the decode of
    its clean form."""
    _, tw, dead = _garbage_wires()
    wire = tw[0]
    codec = tcodec.get_codec(TOPK[1])
    n = dead.shape[0] * SEL
    with tmesh.dp_group(torch.device("cpu")) as g1:
        recv = tcomm.exchange_wire(wire, codec.wire_shapes(n), 1, g1)
    cap = tcodec.topk_cap(TOPK[1])
    assert (recv["idx"].view(torch.int16).reshape(-1, cap).numpy()[dead]
            == 0).all()
    clean = {k: v.clone() for k, v in wire.items()}
    live = torch.from_numpy(~dead).reshape(-1)
    clean["idx"] = torch.where(live, clean["idx"].view(torch.int16),
                               0).view(torch.uint16)
    clean["val"] = torch.where(live, clean["val"], 0.0)
    np.testing.assert_array_equal(
        codec.decode_mean(recv).numpy(),
        codec.decode_mean({k: v[None] for k, v in clean.items()}).numpy())


@pytest.mark.parametrize("D", [1, 2, 4])
def test_topk_group_plan_matches_reference(D):
    layout = (LOCO4, TOPK, _cfgs(0.25), LOCO4)
    jg = JWP.build_group_plan(make_plan(layout, 0, D=D), D, pods=1)
    tg = TWP.build_group_plan(make_plan(layout, 1, D=D), D)
    assert [(g.stage, g.kind, g.peers, g.row_bytes,
             [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype,
               l.count_of) for l in g.leaves]) for g in tg.groups] == [
        (g.stage, g.kind, g.peers, g.row_bytes,
         [(l.bucket, l.name, l.offset, l.nbytes, l.elems, l.dtype,
           l.count_of) for l in g.leaves]) for g in jg.groups]
    assert tg.launches() == jg.launches(axes=1)
    runs = TWP.encode_runs(make_plan(layout, 1, D=D))
    assert [r.buckets for r in runs] == [(0,), (1,), (2,), (3,)]


def test_topk_config_fields_mirror_reference():
    jf = {f.name for f in dataclasses.fields(jloco.SyncConfig)} - {
        "use_kernels"}
    assert jf == {f.name for f in dataclasses.fields(tloco.SyncConfig)}
    assert tloco.validate_tier_codec(TOPK[1]) is TOPK[1]
    with pytest.raises(ValueError, match="stateless"):
        tloco.validate_tier_codec(tloco.SyncConfig(strategy="loco"))
    assert tQ.QuantConfig() == tQ.QuantConfig(**dataclasses.asdict(
        jQ.QuantConfig()))
