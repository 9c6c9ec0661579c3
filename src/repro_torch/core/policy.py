"""Per-bucket compression policy engine (which tensors LoCo compresses, at
what width and when).

Port of ``repro.core.policy``.  An ordered rule list is matched against
(``group/param`` name, tensor class, global element count) and resolves
every bucket of :mod:`repro_torch.core.buckets` to its own
:class:`~repro_torch.core.loco.SyncConfig`; the CLI spec grammar
(:func:`parse_policy`) is the reference's, flags included, and a spec
resolves to the same config fields.  Two differences:

* ``+kernels`` / ``+nokernels`` are accepted and change nothing: the port
  has no ``use_kernels`` field, it picks the CUDA kernel by the tensor's
  device.
* What the port cannot run yet (``topk``, ``+hier``, ``+wan:``) still
  parses, and is refused when a train step is built
  (``launch.steps._validate_sync_configs``).

Everything here is static (frozen dataclasses, resolved when the step is
built), so resolved configs are hashable and key the plan caches of
:mod:`repro_torch.core.wirepack`.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re

from repro_torch.core.loco import SyncConfig, SyncTier, sync_schedule

# cadence / sparsity flag grammar (DESIGN.md section 16): "+topk1%" keeps
# the top 1% of each 512-block, "everyK" is the sync period in steps.
_TOPK_FLAG = re.compile(r"^topk(\d+(?:\.\d+)?)%$")
_EVERY_FLAG = re.compile(r"^every(\d+)$")
_WAN_FLAG = re.compile(r"^wan:topk(\d+(?:\.\d+)?)%(?:every(\d+))?$")

# tensor classes derivable from a ParamInfo (see classify())
TENSOR_CLASSES = ("embed", "norm", "body")


def classify(info) -> str:
    """Map a flatparam.ParamInfo to its tensor class."""
    if info.init == "embed":
        return "embed"
    if len(info.shape) == 1:
        return "norm"
    return "body"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One match clause.  All present conditions must hold (AND)."""

    sync: SyncConfig
    name_glob: str = "*"            # fnmatch over "group/param"
    tensor_class: str | None = None  # embed | norm | body
    min_elems: int = 0               # global elements of the bucket
    max_elems: int | None = None

    def matches(self, qualname: str, tclass: str, n_elems: int) -> bool:
        if self.tensor_class is not None and tclass != self.tensor_class:
            return False
        if n_elems < self.min_elems:
            return False
        if self.max_elems is not None and n_elems > self.max_elems:
            return False
        return fnmatch.fnmatchcase(qualname, self.name_glob)


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """Ordered rules + fallback.  First matching rule wins.

    ``min_compress_elems`` is a final override: buckets smaller than this
    (global elements) fall back to the uncompressed ``fp`` wire.
    """

    default: SyncConfig = dataclasses.field(default_factory=SyncConfig)
    rules: tuple[Rule, ...] = ()
    min_compress_elems: int = 0

    def resolve(self, qualname: str, tclass: str, n_elems: int) -> SyncConfig:
        cfg = self.default
        for r in self.rules:
            if r.matches(qualname, tclass, n_elems):
                cfg = r.sync
                break
        if self.min_compress_elems and n_elems < self.min_compress_elems:
            if cfg.strategy != "fp":
                # hierarchical staging is dropped with the codec: fp has no
                # wire codec to stage
                cfg = dataclasses.replace(cfg, strategy="fp",
                                          hierarchical=False, stage2=None)
        return cfg


def uniform(cfg: SyncConfig) -> SyncPolicy:
    """Policy that resolves every bucket to the same config."""
    return SyncPolicy(default=cfg)


# ---------------------------------------------------------------------------
# named presets + CLI spec parsing
# ---------------------------------------------------------------------------

def _base_preset(name: str, base: SyncConfig) -> SyncConfig:
    """Named wire presets; unlisted fields inherit from the run default."""
    if name == "fp":
        # fp has no wire codec to stage: clear an inherited hierarchical
        # default instead of resolving a combination validation rejects
        return dataclasses.replace(base, strategy="fp",
                                   hierarchical=False, stage2=None)
    if name in ("loco", "loco4"):
        return dataclasses.replace(
            base, strategy="loco", quant=dataclasses.replace(base.quant, bits=4))
    if name == "loco8":
        return dataclasses.replace(
            base, strategy="loco", quant=dataclasses.replace(base.quant, bits=8))
    if name in ("naive4", "ef", "onebit", "topk"):
        return dataclasses.replace(base, strategy=name)
    if name == "naive8":
        return dataclasses.replace(
            base, strategy="naive4", quant=dataclasses.replace(base.quant, bits=8))
    raise ValueError(f"unknown sync preset {name!r}; "
                     "known: fp loco loco4 loco8 naive4 naive8 ef onebit topk")


def _preset(spec: str, base: SyncConfig) -> SyncConfig:
    """Preset name plus optional ``+flag`` modifiers, e.g. ``loco8+every4``.

    ``+kernels`` / ``+nokernels``: accepted, no effect (see the module
    docstring).  ``+hier`` / ``+hier4`` / ``+nohier``: the two-stage
    (pod, data) exchange with an 8-bit (``hier``) or 4-bit (``hier4``)
    block stage 2.  ``+topkN%``: the ragged top-k codec keeping N% of each
    512-block.  ``+everyN``: sync every N-th step (off-cadence gradients
    accumulate in the compensation-error state).  ``+wan:topkN%everyM``:
    a top-k WAN tier above the inter-pod tier.
    """
    name, *flags = spec.split("+")
    cfg = _base_preset(name, base)
    for f in flags:
        if f in ("kernels", "nokernels"):
            continue
        if f == "hier":
            cfg = dataclasses.replace(cfg, hierarchical=True, stage2=None)
        elif f == "hier4":
            cfg = dataclasses.replace(
                cfg, hierarchical=True,
                stage2=SyncConfig(
                    strategy="naive4",
                    quant=dataclasses.replace(cfg.quant, bits=4, mode="block",
                                              stochastic_rounding=False)))
        elif f == "nohier":
            cfg = dataclasses.replace(cfg, hierarchical=False, stage2=None)
        elif (m := _TOPK_FLAG.match(f)):
            cfg = dataclasses.replace(cfg, strategy="topk",
                                      topk_frac=float(m.group(1)) / 100.0)
        elif (m := _EVERY_FLAG.match(f)):
            cfg = dataclasses.replace(cfg, every=int(m.group(1)))
        elif (m := _WAN_FLAG.match(f)):
            # the WAN tier sits above the inter-pod tier: resolve the
            # preset's tier schedule first (hier default if none), then
            # append the top-k WAN leg with its own cadence
            wan_cfg = SyncConfig(strategy="topk",
                                 topk_frac=float(m.group(1)) / 100.0)
            wan = SyncTier(wan_cfg, every=int(m.group(2) or 1))
            base_tiers = sync_schedule(
                dataclasses.replace(cfg, hierarchical=True))
            cfg = dataclasses.replace(cfg, hierarchical=True,
                                      tiers=base_tiers + (wan,))
        else:
            raise ValueError(f"unknown preset flag {f!r} in {spec!r}; "
                             "known flags: kernels nokernels hier hier4 "
                             "nohier topkN% everyN wan:topkN%everyN")
    return cfg


def parse_policy(spec: str, default: SyncConfig) -> SyncPolicy:
    """Parse a CLI policy spec like ``embed=loco8,norm=fp,min=65536``.

    Clause keys: a tensor class (``embed``/``norm``/``body``), a name glob
    (must contain ``/``, ``*``, ``?`` or ``[``, so a typoed class fails at
    launch instead of never matching), or ``min`` (min_compress_elems).
    Clause values are presets with optional flags (see ``_preset``).
    Unmatched buckets use ``default``.
    """
    rules: list[Rule] = []
    min_elems = 0
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        key, _, val = clause.partition("=")
        if not val:
            raise ValueError(f"bad policy clause {clause!r} (want key=value)")
        if key == "min":
            min_elems = int(val)
        elif key in TENSOR_CLASSES:
            rules.append(Rule(sync=_preset(val, default), tensor_class=key))
        elif any(ch in key for ch in "/*?["):
            rules.append(Rule(sync=_preset(val, default), name_glob=key))
        else:
            raise ValueError(
                f"bad policy key {key!r}: not a tensor class "
                f"{TENSOR_CLASSES}, not 'min', and not a name glob "
                "(globs must contain one of / * ? [)")
    return SyncPolicy(default=default, rules=tuple(rules),
                      min_compress_elems=min_elems)
