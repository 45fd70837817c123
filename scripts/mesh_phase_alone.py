#!/usr/bin/env python3
"""``chip_smoke.py`` phase 13 alone, with what it takes from earlier
phases: the kernels built, Fig. 2's anchor designs (phase 4 designs them
on the card; here the anchors the designs start from), and the one-card
reference of the expert-parallel serve that phase 9 makes on its
qwen3-moe-30b-a3b (``chip_smoke.moe_ep_reference``, made here on a model
from the same seed). On a machine with a card:

    python3 scripts/mesh_phase_alone.py

Prints every line phase 13 prints (its checks still stop the run), the
reference's seconds, the phase's seconds and the card's name and power
limit.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase_alone: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import digital_design, ota_design
    from repro_torch.kernels import build
    from repro_torch.launch import distributed
    from repro_torch.models import make_model
    distributed.prestart()
    build.build()
    ospec = chip_smoke.fig2_problem(50)[3]
    dspec = chip_smoke.fig2_problem(10)[4]
    ota_p = ota_design.params_from_gamma(
        ospec, ota_design.anchor_min_noise(ospec))
    dig_p = digital_design.finalize(dspec,
                                    *digital_design.anchor_uniform(dspec))
    t0 = time.perf_counter()
    model = make_model(get_config(chip_smoke.QWEN_MOE), seed=0)
    ep_ref = chip_smoke.moe_ep_reference(model)
    del model
    chip_smoke.free_card()
    chip_smoke.emit(phase="moe_ep_reference",
                    seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches = chip_smoke.mesh_phase(ota_p, dig_p, ep_ref)
    chip_smoke.emit(phase="phase_13_alone",
                    seconds=time.perf_counter() - t0, launches=launches)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
