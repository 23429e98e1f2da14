"""TS ex22 analog: 1-D advection-reaction PDE with IMEX methods.

Counterpart of petsctpu's examples/ex22_imex.py. Reference:
src/ts/examples/tutorials/ex22.c — stiff linear reaction (k ~ 1e6)
treated implicitly, biased 4th-order upwind advection with a
time-dependent inflow BC treated explicitly. Golden runs:

    python -m petsctpu_torch.examples.ex22_imex -da_grid_x 200 \\
        -ts_arkimex_type 4 -ts_adapt_type none
        -> CONVERGED_TIME at time 1.00025 after 4001 steps   (ex22_1.out)
    python -m petsctpu_torch.examples.ex22_imex -da_grid_x 200 \\
        -ts_type rosw -ts_dt 1e-3 -ts_adapt_type none
        -> CONVERGED_TIME at time 1 after 1000 steps         (ex22_2.out)
    python -m petsctpu_torch.examples.ex22_imex -da_grid_x 200 \\
        -ts_type rosw -ts_rosw_type ra34pw2 -ts_dt 5e-3 \\
        -ts_adapt_type none
        -> CONVERGED_TIME at time 1 after 200 steps          (ex22_3.out)

Under -ts_type rosw the stage solves use the IJacobian (reaction only,
jac_fn) exactly as the reference's W-method does.
"""

from __future__ import annotations

import sys

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.models.adr1d import (adr_initial, adr_rhs_advection,
                                         adr_rhs_reaction, ts_reason_string)
from petsctpu_torch.ts.imex import ts_arkimex, ts_rosw
from petsctpu_torch.ts.steppers import TSConfig


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    mx = opts.get_int("da_grid_x", 11)
    a = (opts.get_real("a0", 1.0), opts.get_real("a1", 0.0))
    k0 = opts.get_real("k0", 1e6)
    k = (k0, opts.get_real("k1", 2 * k0))
    s = (opts.get_real("s0", 0.0), opts.get_real("s1", 1.0))

    u0 = adr_initial(mx, a, k, s, device=dev)
    fexp = adr_rhs_advection(mx, a, s)
    fimp = adr_rhs_reaction(mx, k, s)

    max_time, max_steps = 1.0, 10000
    dt = opts.get_real("ts_dt", 0.1 * max(a) / (2 * mx))
    cfg = TSConfig(dt=dt, max_steps=max_steps, max_time=max_time,
                   clamp_final=False)

    ts_type = opts.get_str("ts_type", "arkimex")
    if ts_type == "arkimex":
        tab = opts.get_str("ts_arkimex_type", "3")
        res = ts_arkimex(fexp, fimp, u0, cfg, tableau=tab)
    elif ts_type == "rosw":
        tab = opts.get_str("ts_rosw_type", "ra34pw2")
        res = ts_rosw(lambda t, x: fexp(t, x) + fimp(t, x), u0, cfg,
                      tableau=tab, jac_fn=fimp)
    else:
        raise SystemExit(f"unsupported -ts_type {ts_type}")

    print("%s at time %g after %d steps" % (
        ts_reason_string(int(res.steps), float(res.t), max_steps, max_time),
        float(res.t), int(res.steps)))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
