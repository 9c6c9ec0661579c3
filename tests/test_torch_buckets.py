"""The port's bucket layout and policy engine against the JAX reference (CPU).

``partition``, ``classify``, ``parse_policy`` over a corpus of specs with
every flag, and ``make_sync_plan`` for reduced llama2-400m and reduced
deepseek-v3-moe must equal the reference's field for field (``use_kernels``
aside: the port picks kernels by device and has no such field).  Then the
train step's per-unit error reset, and the refusals, when a step is built,
of what the port has not ported (top-k, ``+hier``, ``+wan:``) and of what
no in-backward sync can run.
"""
import dataclasses
import re
import types

import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import reduced as jreduced
from repro.core import buckets as JBK
from repro.core import policy as JPOL
from repro.core.loco import SyncConfig as JSync
from repro.models import transformer as JTF
from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.core import buckets as TBK
from repro_torch.core import flatparam as TFP
from repro_torch.core import policy as TPOL
from repro_torch.core.flatparam import MeshTopo
from repro_torch.core.loco import SyncConfig as TSync
from repro_torch.core.quantizer import QuantConfig as TQuant
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TTF

ARCHS = ("llama2-400m", "deepseek-v3-moe")


def _fields(cfg) -> dict:
    """A config as nested plain data, ``use_kernels`` dropped everywhere."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k != "use_kernels"}
        if isinstance(x, (list, tuple)):
            return [strip(v) for v in x]
        return x
    return strip(dataclasses.asdict(cfg))


def _plan_fields(plan) -> list:
    return [dict(group=p.group, name=p.name, tensor_class=p.tensor_class,
                 chunklen=p.chunklen, layers=p.layers,
                 buckets=[dict(index=b.index, offset=b.offset,
                               chunk_elems=b.chunk_elems,
                               seg_elems=b.seg_elems, sync=_fields(b.sync))
                          for b in p.buckets])
            for p in plan.params]


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunklen", [512, 1024, 7 * 512, 64 * 512,
                                      2883584])
@pytest.mark.parametrize("target", [1 << 12, 1 << 20, 4 << 20, 104857])
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_partition_matches_reference(chunklen, target, dp):
    got = TBK.partition(chunklen, dp, TBK.BucketConfig(target_bytes=target))
    assert got == JBK.partition(chunklen, dp,
                                JBK.BucketConfig(target_bytes=target))
    assert sum(got) == chunklen and all(c % TBK.ALIGN == 0 for c in got)


def test_partition_rejects_misaligned():
    with pytest.raises(ValueError, match="alignment"):
        TBK.partition(513, 2, TBK.BucketConfig())


@pytest.mark.parametrize("arch", ARCHS)
def test_classify_matches_reference(arch):
    jg = JTF.build_groups(jreduced(jget_arch(arch)), 1)
    tg = TTF.build_groups(reduced(get_arch(arch)), 1)
    got = [TPOL.classify(i) for g in tg for i in g.infos]
    assert got == [JPOL.classify(i) for g in jg for i in g.infos]
    assert {"embed", "norm", "body"} <= set(got)


# ---------------------------------------------------------------------------
# policy grammar
# ---------------------------------------------------------------------------

SPECS = [
    "",
    "embed=loco8",
    "embed=loco8,min=16384",
    "embed=loco8,min=1048576",
    "embed=loco8,norm=fp,min=65536",
    "body=loco4+kernels",
    "body=loco+nokernels,embed=naive8",
    "block/w*=ef,final/*=fp",
    "block/w[12]=naive4,body=onebit",
    "body=loco4+every4",
    "embed=loco8+every2,body=loco4+every2",
    "body=loco+topk1%",
    "body=loco+topk0.5%+every8",
    "body=loco+hier",
    "body=loco8+hier4",
    "body=loco+hier+nohier",
    "norm=fp+hier",
    "body=loco+wan:topk0.5%every16",
    "body=loco+hier4+wan:topk1%",
    "embed=topk,body=loco4+kernels+every2",
]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("base", ["loco", "ef"])
def test_parse_policy_matches_reference(spec, base):
    jdef, tdef = JSync(strategy=base), TSync(strategy=base)
    assert _fields(jdef) == _fields(tdef)
    jp, tp = JPOL.parse_policy(spec, jdef), TPOL.parse_policy(spec, tdef)
    assert _fields(tp) == _fields(jp)
    # and the rules resolve the same buckets the same way
    for qual, tclass in (("embed/tok", "embed"), ("block/w1", "body"),
                         ("final/norm", "norm"), ("head/w", "body")):
        for n in (512, 16383, 16384, 1 << 20):
            assert _fields(tp.resolve(qual, tclass, n)) == \
                _fields(jp.resolve(qual, tclass, n))


@pytest.mark.parametrize("spec", ["embed", "typo=loco8", "embed=loco9",
                                  "body=loco+turbo"])
def test_parse_policy_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError):
        JPOL.parse_policy(spec, JSync())
    with pytest.raises(ValueError):
        TPOL.parse_policy(spec, TSync())


# ---------------------------------------------------------------------------
# whole-model plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("bucket_bytes,spec", [
    (64 << 10, ""),
    (104857, "embed=loco8,min=16384"),
    (4 << 20, "embed=loco8,min=1048576"),
    (1 << 16, "embed=loco8+every2,block/w2=ef,norm=fp"),
])
def test_make_sync_plan_matches_reference(arch, dp, bucket_bytes, spec):
    topo = types.SimpleNamespace(tp=1, dp=dp)
    jpol = JPOL.parse_policy(spec, JSync()) if spec else JPOL.uniform(JSync())
    tpol = TPOL.parse_policy(spec, TSync()) if spec else TPOL.uniform(TSync())
    jplan = JBK.make_sync_plan(JTF.build_groups(jreduced(jget_arch(arch)), 1),
                               topo, JBK.BucketConfig(bucket_bytes), jpol)
    tplan = TBK.make_sync_plan(TTF.build_groups(reduced(get_arch(arch)), 1),
                               topo, TBK.BucketConfig(bucket_bytes), tpol)
    assert _plan_fields(tplan) == _plan_fields(jplan)
    assert tplan.n_buckets == jplan.n_buckets >= len(tplan.params)
    mono = TBK.monolithic_sync_plan(TTF.build_groups(reduced(get_arch(arch)),
                                                     1), topo, TSync())
    assert _plan_fields(mono) == _plan_fields(JBK.monolithic_sync_plan(
        JTF.build_groups(jreduced(jget_arch(arch)), 1), topo, JSync()))


def test_mixed_plan_of_the_reduced_model():
    """The reduced mix of chip_smoke's card-against-CPU check: at dp = 1 a
    bucket is 26,112 elements, every tensor keeps one fp tail and the
    embedding runs at 8 bits."""
    run = tsteps.RunConfig(bucket_bytes=int(0.1 * (1 << 20)),
                           policy=TPOL.parse_policy("embed=loco8,min=16384",
                                                    TSync()))
    plan = tsteps.build_sync_plan(
        run, TTF.build_groups(reduced(get_arch("llama2-400m")), 1),
        types.SimpleNamespace(tp=1, dp=1))
    for p in plan.params:
        *body, tail = p.buckets
        assert tail.sync.strategy == "fp"
        assert tail.chunk_elems in (13312, 512)
        assert all(b.chunk_elems == 26112 and b.sync.strategy == "loco"
                   and b.sync.quant.bits == (8 if p.tensor_class == "embed"
                                             else 4) for b in body)


# ---------------------------------------------------------------------------
# per-unit error reset
# ---------------------------------------------------------------------------

def test_reset_follows_each_units_own_config():
    """At step 512 a loco unit resets, a unit resolved to reset_every=1024
    keeps its error, and non-loco params' dummies are left alone; at 1024
    both loco units reset."""
    cfg = reduced(get_arch("llama2-400m"))
    groups = TTF.build_groups(cfg, 1)
    late = TSync(quant=TQuant(bits=8), reset_every=1024)
    pol = TPOL.SyncPolicy(default=TSync(),
                          rules=(TPOL.Rule(sync=late, tensor_class="embed"),))
    run = tsteps.RunConfig(bucket_bytes=1 << 16, policy=pol)
    topo = types.SimpleNamespace(tp=1, dp=1, rank=0)
    plan = tsteps.build_sync_plan(run, groups, topo)
    _, states = TFP.init_train_state(groups, run.sync, topo, "cpu", 0,
                                     plan=plan)
    for g in states.values():
        for name, s in g.items():
            for u in (s if isinstance(s, tuple) else (s,)):
                u.fill_(1.0) if u.dtype == torch.float32 else \
                    u.copy_(torch.ones(u.shape).to(u.dtype))

    def level(st):
        return {f"{gn}/{n}": [float(u.float().abs().max())
                              for u in (s if isinstance(s, tuple) else (s,))]
                for gn, g in st.items() for n, s in g.items()}

    at512 = level(tsteps.reset_states(states, 512, groups, run, plan))
    assert at512["embed/tok"] == [1.0]                 # reset_every 1024
    assert all(v == [0.0] for k, v in at512.items()
               if k.startswith("block/w"))
    assert at512["block/norm1"] == [1.0]           # dummy, not loco
    at1024 = level(tsteps.reset_states(states, 1024, groups, run, plan))
    assert at1024["embed/tok"] == [0.0]
    assert level(tsteps.reset_states(states, 511, groups, run, plan)) == \
        level(states)
    # the monolithic path resets loco states under the global config
    _, mono = TFP.init_train_state(groups, run.sync, topo, "cpu", 0)
    for g in mono.values():
        for s in g.values():
            s.copy_(torch.ones(s.shape).to(s.dtype))
    m = level(tsteps.reset_states(mono, 512, groups, run, None))
    assert m["embed/tok"] == [0.0] and m["block/norm1"] == [1.0]


# ---------------------------------------------------------------------------
# what a step build refuses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group1():
    with tmesh.dp_group(torch.device("cpu")) as g:
        yield g


def _build(group, spec, overlap=True, **kw):
    run = tsteps.RunConfig(bucket_bytes=1 << 16, overlap=overlap,
                           policy=TPOL.parse_policy(spec, TSync(**kw)))
    tsteps.make_train_step(reduced(get_arch("llama2-400m")), run,
                           MeshTopo.from_group(group), torch.device("cpu"),
                           ShapeConfig("t", 32, 8, "train"))


def _reference_verdict(spec, overlap=True):
    """The reference's build-time verdict on the same run at dp = 1 (one
    pod): its ValueError message, or None when it builds."""
    from repro.core.flatparam import MeshTopo as JTopo
    from repro.launch import steps as jsteps

    run = jsteps.RunConfig(bucket_bytes=1 << 16, overlap=overlap,
                           policy=JPOL.parse_policy(spec, JSync()))
    topo = JTopo(dp_axes=("data",), tp_axis="model", dp=1, tp=1)
    groups = jsteps.build_model(jreduced(jget_arch("llama2-400m")),
                                1).groups()
    try:
        jsteps._validate_sync_configs(
            run, jsteps.build_sync_plan(run, groups, topo), topo)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("spec,what", [
    ("body=loco+topk1%", "topk"),
    ("embed=topk", "topk"),
    ("body=loco+hier", "hierarchical"),
    ("body=loco8+hier4", "hierarchical"),
    ("body=loco+wan:topk0.5%every16", "hierarchical"),
])
def test_unported_buckets_are_refused(group1, spec, what):
    """Top-k and tiered buckets are ported: on one pod the step build does
    what the reference's does with the same run, for the pipelined and the
    flat schedule -- a single-pod ``+hier`` or ``+wan:`` bucket and a top-k
    bucket on a pipelined overlap schedule are refused with the
    reference's ValueError, word for word, and what the reference builds
    builds."""
    verdicts = []
    for overlap in (True, False):
        want = _reference_verdict(spec, overlap)
        verdicts.append(want)
        if want is None:
            _build(group1, spec, overlap=overlap)
            continue
        with pytest.raises(ValueError) as e:
            _build(group1, spec, overlap=overlap)
        assert str(e.value) == want
        assert re.match(r"^\w+/\w+(\[\d+\])?: ", want), want
    if what == "hierarchical":
        assert all(v is not None and ("--pods >= 2" in v or "--wans >= 2"
                                      in v) for v in verdicts), verdicts
    else:
        assert verdicts[1] is None and verdicts[0] is not None \
            and "--no-overlap" in verdicts[0], verdicts


@pytest.mark.parametrize("spec,kw,match", [
    ("body=loco4", dict(quant=TQuant(stochastic_rounding=True)),
     r"\[0\]: stochastic_rounding"),
    ("body=fp+every2", {}, r"\[0\]: sync cadence every=2 needs a stateful"),
    ("body=loco+every3", {}, r"\[0\]: reset_every=512 must be a multiple"),
])
def test_unrunnable_buckets_are_refused(group1, spec, kw, match):
    with pytest.raises(ValueError, match=match):
        _build(group1, spec, **kw)


def test_runnable_mix_builds(group1):
    # cadence buckets run on the flat schedule only (as in the reference,
    # whose default schedule is the overlapped one)
    spec = ("embed=loco8+every2,body=loco4+every2,norm=fp,"
            "block/w2=ef,block/w3=naive8,final/*=onebit")
    _build(group1, spec, overlap=False)
    with pytest.raises(ValueError, match="every=2 .*--no-overlap"):
        _build(group1, spec)


# ---------------------------------------------------------------------------
# wire report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("bucket_bytes,spec", [
    (104857, "embed=loco8,min=16384"),
    (1 << 16, "embed=naive8,block/w2=ef,final/*=onebit,norm=fp"),
])
def test_plan_report_matches_reference(arch, dp, bucket_bytes, spec):
    from repro.telemetry import wire as JW
    from repro_torch.telemetry import wire as TW

    topo = types.SimpleNamespace(tp=1, dp=dp)
    jplan = JBK.make_sync_plan(
        JTF.build_groups(jreduced(jget_arch(arch)), 1), topo,
        JBK.BucketConfig(bucket_bytes), JPOL.parse_policy(spec, JSync()))
    tplan = TBK.make_sync_plan(
        TTF.build_groups(reduced(get_arch(arch)), 1), topo,
        TBK.BucketConfig(bucket_bytes), TPOL.parse_policy(spec, TSync()))
    j, t = JW.plan_report(jplan), TW.plan_report(tplan)
    keys = [f.name for f in dataclasses.fields(TW.BucketWire)]
    assert [[getattr(r, k) for k in keys] for r in t.buckets] == \
        [[getattr(r, k) for k in keys] for r in j.buckets]
    for k in ("total_wire", "fp32_bytes", "bf16_bytes", "state_bytes",
              "launches_per_bucket", "launches_coalesced", "comm_groups"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.by_class() == j.by_class()
    text = TW.format_report(t)
    assert text.splitlines()[0] == JW.format_report(j).splitlines()[0]
    assert f"{t.launches_coalesced} coalesced" in text


@pytest.mark.parametrize("cfg", [
    TSync(), TSync(quant=TQuant(bits=8)), TSync(strategy="ef"),
    TSync(strategy="naive4", quant=TQuant(mode="tensor")),
    TSync(strategy="onebit")])
def test_wire_prediction_matches_encoded_bytes(cfg):
    from repro_torch.core import codec as tcodec
    from repro_torch.core import loco as tloco
    from repro_torch.telemetry import wire as TW

    n = 4 * 1024
    wire, _ = tcodec.get_codec(cfg).encode(torch.randn(n) * 1e-3,
                                           tloco.init_state(cfg, n))
    got = sum(t.numel() * t.element_size() for t in wire.values())
    assert got == TW.payload_bytes(n, cfg) + TW.scale_bytes(n, cfg)


@pytest.mark.parametrize("kw", [
    dict(strategy="naive4"), dict(strategy="naive4", hierarchical=True),
    dict(strategy="loco"), dict(strategy="topk"),
    dict(strategy="naive4", quant="sr"), dict(strategy="fp")])
def test_validate_tier_codec_matches_reference(kw):
    from repro.core import loco as jloco
    from repro.core import quantizer as jQ
    from repro_torch.core import loco as tloco

    kw = dict(kw)
    q = kw.pop("quant", None)
    jq = jQ.QuantConfig(stochastic_rounding=q == "sr")
    tq = TQuant(stochastic_rounding=q == "sr")
    outcome = []
    for mod, cfg in ((jloco, JSync(quant=jq, **kw)),
                     (tloco, TSync(quant=tq, **kw))):
        try:
            mod.validate_tier_codec(cfg)
            outcome.append("ok")
        except ValueError as e:
            outcome.append(str(e).split(":")[0][:40])
    assert outcome[0] == outcome[1]
    kw["hierarchical"] = True
    assert [_fields(t) for t in tloco.sync_schedule(TSync(**kw))] == \
        [_fields(t) for t in jloco.sync_schedule(JSync(**kw))]
