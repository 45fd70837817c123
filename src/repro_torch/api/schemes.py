"""Scheme registry: spec keys -> Sec.-V aggregator constructors
(counterpart of ``repro.api.schemes``).

Maps the short scheme keys used in ``ScenarioSpec.schemes`` onto the
port's ``core.baselines`` constructors (all 17 keys build), records which
keys need a Sec.-IV design solve (and of which family), and defines the
named suites the figures declare (``"suite:fig2_ota"`` etc.) in the
reference's order.
"""
from __future__ import annotations

from ..core import baselines as B

#: scheme key -> (design family, variant) for schemes that consume designed
#: parameters; "designed" routes through the (batched) sweep solver, while
#: "direct" uses the per-point reduced SciPy solver (fig2's cross-check).
DESIGN_NEEDS = {
    "proposed_ota": ("ota", "designed"),
    "proposed_ota_direct": ("ota", "direct"),
    "proposed_digital": ("digital", "designed"),
    "proposed_digital_direct": ("digital", "direct"),
}

#: Named suites (legacy pipeline ordering, proposed-first conventions).
SUITES = {
    # fig2 a/b: all Sec. V-A-1 OTA baselines + the direct-solver variant
    "fig2_ota": ("ideal", "proposed_ota", "proposed_ota_direct",
                 "opc_ota_fl", "opc_ota_comp", "lcpc_ota_comp",
                 "vanilla_ota", "bbfl_interior", "bbfl_alternative"),
    # fig2 c/d: Sec. V-A-2 digital selection suite + direct variant
    "fig2_digital": ("proposed_digital", "proposed_digital_direct",
                     "fedtoe", "prop_fairness", "best_channel_norm",
                     "best_channel", "uqos", "qml"),
    # fig3: OTA suite minus the genie OPC OTA-FL (PL condition + future
    # CSI; paper excludes it in the non-convex comparison), no direct
    "fig3_ota": ("ideal", "proposed_ota", "opc_ota_comp", "lcpc_ota_comp",
                 "vanilla_ota", "bbfl_interior", "bbfl_alternative"),
}


def _wargs(ctx):
    cfg = ctx.dep.cfg
    return (ctx.task.dim, ctx.task.g_max, cfg.energy_per_symbol,
            cfg.noise_power)


def _dargs(ctx):
    return _wargs(ctx) + (ctx.dep.cfg.bandwidth_hz,)


_BUILDERS = {
    "ideal": lambda c: B.IdealFedAvg(),
    "proposed_ota": lambda c: B.ProposedOTA(c.ota_params),
    "proposed_ota_direct": lambda c: B.ProposedOTA(
        c.ota_params_direct, label="Proposed OTA-FL (direct)"),
    "opc_ota_fl": lambda c: B.OPCOTAFL(*_wargs(c)),
    "opc_ota_comp": lambda c: B.OPCOTAComp(*_wargs(c)),
    "lcpc_ota_comp": lambda c: B.LCPCOTAComp(c.dep, *_wargs(c)),
    "vanilla_ota": lambda c: B.VanillaOTA(*_wargs(c)),
    "bbfl_interior": lambda c: B.BBFLInterior(c.dep, *_wargs(c)),
    "bbfl_alternative": lambda c: B.BBFLAlternative(c.dep, *_wargs(c)),
    "proposed_digital": lambda c: B.ProposedDigital(c.dig_params),
    "proposed_digital_direct": lambda c: B.ProposedDigital(
        c.dig_params_direct, label="Proposed Digital FL (direct)"),
    "fedtoe": lambda c: B.FedTOE(c.dep, *_dargs(c), k=c.top_k),
    "prop_fairness": lambda c: B.PropFairness(c.dep, *_dargs(c), k=c.top_k),
    "best_channel_norm": lambda c: B.BestChannelNorm(c.dep, *_dargs(c),
                                                     k=c.top_k),
    "best_channel": lambda c: B.BestChannel(c.dep, *_dargs(c), k=c.top_k),
    "uqos": lambda c: B.UQOS(c.dep, *_dargs(c), k=c.top_k),
    "qml": lambda c: B.QML(c.dep, *_dargs(c), k=c.top_k),
}


def scheme_keys() -> tuple:
    return tuple(_BUILDERS)


def expand_schemes(schemes) -> tuple:
    """Resolve ``suite:*`` aliases and validate keys, preserving order."""
    out = []
    for entry in schemes:
        if entry.startswith("suite:"):
            suite = entry[len("suite:"):]
            if suite not in SUITES:
                raise KeyError(f"unknown suite {suite!r}; "
                               f"have {sorted(SUITES)}")
            out.extend(SUITES[suite])
        elif entry in _BUILDERS:
            out.append(entry)
        else:
            raise KeyError(f"unknown scheme key {entry!r}; "
                           f"have {sorted(_BUILDERS)}")
    return tuple(out)


def design_families(schemes) -> dict:
    """{family: needs_direct} over the (expanded) scheme keys."""
    fams: dict = {}
    for key in expand_schemes(schemes):
        need = DESIGN_NEEDS.get(key)
        if need is None:
            continue
        family, variant = need
        fams[family] = fams.get(family, False) or (variant == "direct")
    return fams


def build_scheme(key: str, ctx):
    """Instantiate one aggregator against a materialized cell context."""
    return _BUILDERS[key](ctx)
