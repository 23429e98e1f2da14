"""IMEX additive Runge-Kutta and Rosenbrock-W steppers.

Counterpart of petsctpu/ts/imex.py (reference:
src/ts/impls/arkimex/arkimex.c — TSARKIMEX: TSStep_ARKIMEX :658,
TSEvaluateStep_ARKIMEX :598, the tableau family registered in
TSARKIMEXRegisterAll :215-413 — and src/ts/impls/rosw/rosw.c — TSROSW:
TSStep_RosW, TSRosWRegister :700 with its A·Γ⁻¹ transform,
TSRosWRegisterRos4 :830, TSRosWRegisterAll :308-588).

  * ARKIMEX: u' = f_E(t,u) + f_I(t,u); an explicit tableau A advances
    f_E while a DIRK tableau At handles f_I — each implicit stage is a
    Newton solve (snes_solve) in the step loop. All 13 reference
    tableaus are registered; stage equations follow TSStep_ARKIMEX:
      explicit stage (At_ii=0): Y_i = u + h Σ_j (At_ij FI_j + A_ij FE_j)
      implicit stage:  Y_i − h·At_ii·f_I(t+ct_i h, Y_i) =
                       u + h Σ_j<i (At_ij FI_j + A_ij FE_j)
    completed with u⁺ = u + h Σ (bt_j FI_j + b_j FE_j); the embedded
    (bembedt, bembed) row gives the order-(p−1) error estimate for the
    basic step controller.
  * ROSW: linearly implicit Rosenbrock-W — ONE Jacobian per step
    (frozen at (t, u): a Shell around torch.func.jvp), one LINEAR solve
    per stage through KSP_REGISTRY[cfg.ksp.ksp_type] (the reference
    forces SNESKSPONLY, rosw.c:1417), in the reference's transformed
    variables Y_i = h·Γ·k:
      Zstage = u + Σ_j<i At_ij Y_j,  Zdot = (1/h) Σ_j<i Γinv_ij Y_j
      implicit: (I/(hΓ_ii) − J) Y_i = f(t*, Zstage) − Zdot
      explicit (Γ_ii=0): Y_i = h(f(t*, Zstage) − Zdot + J·Σ GEC_ij Y_j)
      u⁺ = u + Σ bt_i Y_i                (bt = b·Γ⁻¹, At = A·Γ⁻¹)
    All 16 reference tableaus are registered, the Ros4-constructed
    grk4t, shamp4, veldd4 and 4l by register_ros4's order-condition
    solve with its literal PETSC_DEFAULT = -2 a2 parameter.

The tableau registrations are numpy host code, a copy of petsctpu's, so
the arrays are byte-equal to the reference's. The step loops are eager
Python loops; the time and step size are host scalars of the state's
dtype (steppers.py), and an adaptive step's accept/reject is one host
read.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from petsctpu_torch.ksp.api import KSP_REGISTRY
from petsctpu_torch.mat.base import Shell
from petsctpu_torch.snes.api import snes_solve
from petsctpu_torch.ts.steppers import (TSConfig, TSResult,
                                        _basic_controller, _monitor,
                                        configure, result, running,
                                        step_size, time_dtype)

# ---------------------------------------------------------------------------
# ARKIMEX tableaus (arkimex.c:215-413). Registration semantics follow
# TSARKIMEXRegister (arkimex.c:500): bt/b default to the LAST ROW OF At
# (the additive pair shares b), ct/c default to tableau row sums.
# ---------------------------------------------------------------------------

_ARK_TABLEAUS = {}


def register_arkimex(name, order, At, A, b=None, bembedt=None):
    """Register an additive IMEX-RK tableau (TSARKIMEXRegister analog)."""
    At = np.asarray(At, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    s = At.shape[0]
    bt = np.asarray(b, np.float64) if b is not None else At[-1].copy()
    be = np.asarray(b, np.float64) if b is not None else At[-1].copy()
    ct = At.sum(axis=1)
    c = A.sum(axis=1)
    bembedt = (np.asarray(bembedt, np.float64)
               if bembedt is not None else None)
    _ARK_TABLEAUS[name] = dict(order=order, s=s, At=At, A=A, bt=bt, b=be,
                               ct=ct, c=c, bembedt=bembedt, bembed=bembedt)
    return _ARK_TABLEAUS[name]


def _register_all_arkimex():
    s2 = np.sqrt(2.0)
    # 1bee: backward-Euler + extrapolation, implicit first stage
    register_arkimex(
        "1bee", 2,
        At=[[1.0, 0, 0], [0, 0.5, 0], [0, 0.5, 0.5]],
        A=[[0, 0, 0], [0, 0, 0], [0, 0.5, 0]],
        b=[0.0, 0.5, 0.5], bembedt=[1.0, 0.0, 0.0])
    register_arkimex(
        "ars122", 2,
        At=[[0, 0], [0, 0.5]], A=[[0, 0], [0.5, 0]],
        b=[0.0, 1.0], bembedt=[0.5, 0.5])
    register_arkimex(
        "a2", 2,
        At=[[0, 0], [0, 0.5]], A=[[0, 0], [1.0, 0]],
        b=[0.5, 0.5], bembedt=[0.0, 1.0])
    us2 = 1.0 - 1.0 / s2
    register_arkimex(
        "l2", 2,
        At=[[us2, 0], [1.0 - 2.0 * us2, us2]], A=[[0, 0], [1.0, 0]],
        b=[0.5, 0.5], bembedt=[0.0, 1.0])
    two_stage_At = [[0, 0, 0],
                    [1 - 1 / s2, 1 - 1 / s2, 0],
                    [1 / (2 * s2), 1 / (2 * s2), 1 - 1 / s2]]
    bemb3 = [(4.0 - s2) / 8.0, (4.0 - s2) / 8.0, 1 / (2.0 * s2)]
    register_arkimex("2c", 2, At=two_stage_At,
                     A=[[0, 0, 0], [2 - s2, 0, 0], [0.5, 0.5, 0]],
                     bembedt=bemb3)
    register_arkimex("2d", 2, At=two_stage_At,
                     A=[[0, 0, 0], [2 - s2, 0, 0], [0.75, 0.25, 0]],
                     bembedt=bemb3)
    register_arkimex("2e", 2, At=two_stage_At,
                     A=[[0, 0, 0], [2 - s2, 0, 0],
                        [(3 - 2 * s2) / 6, (3 + 2 * s2) / 6, 0]],
                     bembedt=bemb3)
    register_arkimex(
        "prssp2", 2,
        At=[[0.25, 0, 0], [0, 0.25, 0], [1 / 3, 1 / 3, 1 / 3]],
        A=[[0, 0, 0], [0.5, 0, 0], [0.5, 0.5, 0]])
    # Kennedy-Carpenter ARK3(2)4L[2]SA
    register_arkimex(
        "3", 3,
        At=[[0, 0, 0, 0],
            [1767732205903. / 4055673282236., 1767732205903. / 4055673282236., 0, 0],
            [2746238789719. / 10658868560708., -640167445237. / 6845629431997.,
             1767732205903. / 4055673282236., 0],
            [1471266399579. / 7840856788654., -4482444167858. / 7529755066697.,
             11266239266428. / 11593286722821., 1767732205903. / 4055673282236.]],
        A=[[0, 0, 0, 0],
           [1767732205903. / 2027836641118., 0, 0, 0],
           [5535828885825. / 10492691773637., 788022342437. / 10882634858940., 0, 0],
           [6485989280629. / 16251701735622., -4246266847089. / 9704473918619.,
            10755448449292. / 10357097424841., 0]],
        bembedt=[2756255671327. / 12835298489170., -10771552573575. / 22201958757719.,
                 9247589265047. / 10645013368117., 2193209047091. / 5459859503100.])
    register_arkimex(
        "ars443", 3,
        At=[[0, 0, 0, 0, 0],
            [0, 1. / 2, 0, 0, 0],
            [0, 1. / 6, 1. / 2, 0, 0],
            [0, -1. / 2, 1. / 2, 1. / 2, 0],
            [0, 3. / 2, -3. / 2, 1. / 2, 1. / 2]],
        A=[[0, 0, 0, 0, 0],
           [1. / 2, 0, 0, 0, 0],
           [11. / 18, 1. / 18, 0, 0, 0],
           [5. / 6, -5. / 6, .5, 0, 0],
           [1. / 4, 7. / 4, 3. / 4, -7. / 4, 0]])
    register_arkimex(
        "bpr3", 3,
        At=[[0, 0, 0, 0, 0],
            [.5, .5, 0, 0, 0],
            [5. / 18, -1. / 9, .5, 0, 0],
            [.5, 0, 0, .5, 0],
            [.25, 0, .75, -.5, .5]],
        A=[[0, 0, 0, 0, 0],
           [1, 0, 0, 0, 0],
           [4. / 9, 2. / 9, 0, 0, 0],
           [1. / 4, 0, 3. / 4, 0, 0],
           [1. / 4, 0, 3. / 5, 0, 0]])
    # Kennedy-Carpenter ARK4(3)6L[2]SA
    register_arkimex(
        "4", 4,
        At=[[0, 0, 0, 0, 0, 0],
            [1. / 4, 1. / 4, 0, 0, 0, 0],
            [8611. / 62500., -1743. / 31250., 1. / 4, 0, 0, 0],
            [5012029. / 34652500., -654441. / 2922500., 174375. / 388108., 1. / 4, 0, 0],
            [15267082809. / 155376265600., -71443401. / 120774400.,
             730878875. / 902184768., 2285395. / 8070912., 1. / 4, 0],
            [82889. / 524892., 0, 15625. / 83664., 69875. / 102672.,
             -2260. / 8211, 1. / 4]],
        A=[[0, 0, 0, 0, 0, 0],
           [1. / 2, 0, 0, 0, 0, 0],
           [13861. / 62500., 6889. / 62500., 0, 0, 0, 0],
           [-116923316275. / 2393684061468., -2731218467317. / 15368042101831.,
            9408046702089. / 11113171139209., 0, 0, 0],
           [-451086348788. / 2902428689909., -2682348792572. / 7519795681897.,
            12662868775082. / 11960479115383., 3355817975965. / 11060851509271., 0, 0],
           [647845179188. / 3216320057751., 73281519250. / 8382639484533.,
            552539513391. / 3454668386233., 3354512671639. / 8306763924573.,
            4040. / 17871., 0]],
        bembedt=[4586570599. / 29645900160., 0, 178811875. / 945068544.,
                 814220225. / 1159782912., -3700637. / 11593932., 61727. / 225920.])
    # Kennedy-Carpenter ARK5(4)8L[2]SA
    register_arkimex(
        "5", 5,
        At=[[0, 0, 0, 0, 0, 0, 0, 0],
            [41. / 200., 41. / 200., 0, 0, 0, 0, 0, 0],
            [41. / 400., -567603406766. / 11931857230679., 41. / 200., 0, 0, 0, 0, 0],
            [683785636431. / 9252920307686., 0, -110385047103. / 1367015193373.,
             41. / 200., 0, 0, 0, 0],
            [3016520224154. / 10081342136671., 0, 30586259806659. / 12414158314087.,
             -22760509404356. / 11113319521817., 41. / 200., 0, 0, 0],
            [218866479029. / 1489978393911., 0, 638256894668. / 5436446318841.,
             -1179710474555. / 5321154724896., -60928119172. / 8023461067671.,
             41. / 200., 0, 0],
            [1020004230633. / 5715676835656., 0, 25762820946817. / 25263940353407.,
             -2161375909145. / 9755907335909., -211217309593. / 5846859502534.,
             -4269925059573. / 7827059040749., 41. / 200, 0],
            [-872700587467. / 9133579230613., 0, 0, 22348218063261. / 9555858737531.,
             -1143369518992. / 8141816002931., -39379526789629. / 19018526304540.,
             32727382324388. / 42900044865799., 41. / 200.]],
        A=[[0, 0, 0, 0, 0, 0, 0, 0],
           [41. / 100, 0, 0, 0, 0, 0, 0, 0],
           [367902744464. / 2072280473677., 677623207551. / 8224143866563., 0, 0, 0, 0, 0, 0],
           [1268023523408. / 10340822734521., 0, 1029933939417. / 13636558850479., 0, 0, 0, 0, 0],
           [14463281900351. / 6315353703477., 0, 66114435211212. / 5879490589093.,
            -54053170152839. / 4284798021562., 0, 0, 0, 0],
           [14090043504691. / 34967701212078., 0, 15191511035443. / 11219624916014.,
            -18461159152457. / 12425892160975., -281667163811. / 9011619295870., 0, 0, 0],
           [19230459214898. / 13134317526959., 0, 21275331358303. / 2942455364971.,
            -38145345988419. / 4862620318723., -1. / 8, -1. / 8, 0, 0],
           [-19977161125411. / 11928030595625., 0, -40795976796054. / 6384907823539.,
            177454434618887. / 12078138498510., 782672205425. / 8267701900261.,
            -69563011059811. / 9646580694205., 7356628210526. / 4942186776405., 0]],
        bembedt=[-975461918565. / 9796059967033., 0, 0,
                 78070527104295. / 32432590147079., -548382580838. / 3424219808633.,
                 -33438840321285. / 15594753105479., 3629800801594. / 4656183773603.,
                 4035322873751. / 18575991585200.])


_register_all_arkimex()


# ---------------------------------------------------------------------------
# Rosenbrock-W tableaus (rosw.c:308-588). TSRosWRegister's transform
# (rosw.c:700): Γinv (zero diagonals → 1 before inversion), At = A·Γ⁻¹,
# bt = b·Γ⁻¹, GEC = Γ·Γ⁻¹ (explicit-stage correction weights).
# ---------------------------------------------------------------------------

_ROSW_TABLEAUS = {}


def register_rosw(name, order, A, Gamma, b, bembed=None):
    """Register a Rosenbrock-W tableau (TSRosWRegister analog)."""
    A = np.atleast_2d(np.asarray(A, np.float64))
    Gamma = np.atleast_2d(np.asarray(Gamma, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    s = A.shape[0]
    gzd = np.diag(Gamma) == 0.0
    Gmod = Gamma.copy()
    for i in range(s):
        if gzd[i]:
            Gmod[i, i] = 1.0
    GammaInv = np.linalg.inv(Gmod)
    tab = dict(order=order, s=s, A=A, Gamma=Gamma, b=b,
               GammaInv=GammaInv, GammaZeroDiag=gzd,
               GammaExplicitCorr=Gamma @ GammaInv,
               ASum=A.sum(axis=1), At=A @ GammaInv, bt=b @ GammaInv,
               bembedt=(np.asarray(bembed, np.float64) @ GammaInv
                        if bembed is not None else None))
    _ROSW_TABLEAUS[name] = tab
    return tab


def register_ros4(name, gamma, a2=-2.0, a3=None, b3=0.0, e4=0.0):
    """Construct a 4th-order Rosenbrock scheme from Hairer & Wanner
    design parameters (TSRosWRegisterRos4, rosw.c:830 — the reference
    passes PETSC_DEFAULT=-2 for a2, reproduced here as the default so
    the grk4t/shamp4/veldd4/4l tableaus match bit-for-bit)."""
    g = gamma
    p32 = 1 / 6 - g + g * g
    p42 = 1 / 8 - g / 3
    p43 = 1 / 12 - g / 3
    p44 = 1 / 24 - g / 2 + 1.5 * g * g - g ** 3
    p56 = 1 / 20 - g / 4
    if a3 is None:
        a3 = (1 / 5 - a2 / 4) / (1 / 4 - a2 / 3)          # HW Eq 7.22
    a4 = a3
    M = np.array([[1.0, 1.0, 1.0],
                  [0.0, a2 * a2, a4 * a4],
                  [0.0, a2 ** 3, a4 ** 3]])
    rhs = np.array([1 - b3, 1 / 3 - a3 * a3 * b3, 1 / 4 - a3 ** 3 * b3])
    b1, b2, b4 = np.linalg.solve(M, rhs)
    beta43 = (p56 - a2 * p43) / (b4 * a3 * a3 * (a3 - a2))      # 7.21
    b32b2p = p44 / (b4 * beta43)                                # 7.15h
    b4jbjp = (p32 - b3 * b32b2p) / b4
    M2 = np.array([[b2, b3, b4],
                   [a4 * a4 * b32b2p - a3 * a3 * b4jbjp,
                    a2 * a2 * b4jbjp, -a2 * a2 * b32b2p],
                   [b4 * beta43 * a3 * a3 - p43, -b4 * beta43 * a2 * a2, 0]])
    rhs2 = np.array([0.5 - g, 0.0, -a2 * a2 * p32])
    beta2p, beta3p, beta4p = np.linalg.solve(M2, rhs2)
    beta32 = b32b2p / beta2p
    beta42 = (b4jbjp - beta43 * beta3p) / beta2p
    a43 = 0.0
    a32 = p42 / (b3 * a3 * beta2p + b4 * a4 * beta2p)
    a42 = a32
    A = np.array([[0, 0, 0, 0],
                  [a2, 0, 0, 0],
                  [a3 - a32, a32, 0, 0],
                  [a4 - a43 - a42, a42, a43, 0]])
    Gm = np.array([[g, 0, 0, 0],
                   [beta2p - A[1, 0], g, 0, 0],
                   [beta3p - beta32 - A[2, 0], beta32 - A[2, 1], g, 0],
                   [beta4p - beta42 - beta43 - A[3, 0], beta42 - A[3, 1],
                    beta43 - A[3, 2], g]])
    b = np.array([b1, b2, b3, b4])
    bm = np.empty(4)
    bm[3] = b[3] - e4 * g
    bm[2] = (p32 - b4jbjp * bm[3]) / (beta32 * beta2p)
    bm[1] = (0.5 - g - beta3p * bm[2] - beta4p * bm[3]) / beta2p
    bm[0] = 1.0 - bm[1] - bm[2] - bm[3]
    misfit = a2 * a2 * bm[1] + a3 * a3 * bm[2] + a4 * a4 * bm[3] - 1 / 3
    if abs(misfit) > 1e-10:
        raise ValueError("could not construct 3rd-order embedded method")
    return register_rosw(name, 4, A, Gm, b, bm)


def _register_all_rosw():
    register_rosw("theta1", 1, [[0.0]], [[1.0]], [1.0])
    register_rosw("theta2", 2, [[0.0]], [[0.5]], [1.0])
    for nm, g in (("2p", 1.0 + 1.0 / np.sqrt(2.0)),
                  ("2m", 1.0 - 1.0 / np.sqrt(2.0))):
        register_rosw(nm, 2, [[0, 0], [1.0, 0]], [[g, 0], [-2 * g, g]],
                      [0.5, 0.5], [1.0, 0.0])
    g = 7.8867513459481287e-01
    register_rosw(
        "ra3pw", 3,
        A=[[0, 0, 0], [1.5773502691896257e+00, 0, 0], [0.5, 0, 0]],
        Gamma=[[g, 0, 0], [-1.5773502691896257e+00, g, 0],
               [-6.7075317547305480e-01, -1.7075317547305482e-01, g]],
        b=[1.0566243270259355e-01, 4.9038105676657971e-02, 8.4529946162074843e-01],
        bembed=[-1.7863279495408180e-01, 1. / 3., 8.4529946162074843e-01])
    g = 4.3586652150845900e-01
    register_rosw(
        "ra34pw2", 3,
        A=[[0, 0, 0, 0], [8.7173304301691801e-01, 0, 0, 0],
           [8.4457060015369423e-01, -1.1299064236484185e-01, 0, 0],
           [0, 0, 1., 0]],
        Gamma=[[g, 0, 0, 0], [-8.7173304301691801e-01, g, 0, 0],
               [-9.0338057013044082e-01, 5.4180672388095326e-02, g, 0],
               [2.4212380706095346e-01, -1.2232505839045147e+00,
                5.4526025533510214e-01, g]],
        b=[2.4212380706095346e-01, -1.2232505839045147e+00,
           1.5452602553351020e+00, 4.3586652150845900e-01],
        bembed=[3.7810903145819369e-01, -9.6042292212423178e-02, 0.5,
                2.1793326075422950e-01])
    register_rosw(
        "rodas3", 3,
        A=[[0, 0, 0, 0], [0, 0, 0, 0], [1., 0, 0, 0],
           [0.75, -0.25, 0.5, 0]],
        Gamma=[[0.5, 0, 0, 0], [1., 0.5, 0, 0], [-0.25, -0.25, 0.5, 0],
               [1. / 12, 1. / 12, -2. / 3, 0.5]],
        b=[5. / 6, -1. / 6, -1. / 6, 0.5],
        bembed=[0.75, -0.25, 0.5, 0])
    g = 0.43586652150845899941601945119356
    register_rosw(
        "sandu3", 3,
        A=[[0, 0, 0], [g, 0, 0], [g, 0, 0]],
        Gamma=[[g, 0, 0], [-0.19294655696029095575009695436041, g, 0],
               [0, 1.74927148125794685173529749738960, g]],
        b=[-0.75457412385404315829818998646589,
           1.94100407061964420292840123379419,
           -0.18642994676560104463021124732829],
        bembed=[-1.53358745784149585370766523913002,
                2.81745131148625772213931745457622,
                -0.28386385364476186843165221544619])
    s3 = np.sqrt(3.0)
    g = (3.0 + s3) / 6.0
    register_rosw(
        "assp3p3s1c", 3,
        A=[[0, 0, 0], [1, 0, 0], [0.25, 0.25, 0]],
        Gamma=[[0, 0, 0], [(-3.0 - s3) / 6.0, g, 0],
               [(-3.0 - s3) / 24.0, (-3.0 - s3) / 8.0, g]],
        b=[1. / 6., 1. / 6., 2. / 3.],
        bembed=[1. / 4., 1. / 4., 1. / 2.])
    ssp_A = [[0, 0, 0, 0], [1. / 2., 0, 0, 0], [1. / 2., 1. / 2., 0, 0],
             [1. / 6., 1. / 6., 1. / 6., 0]]
    register_rosw(
        "lassp3p4s2c", 3, A=ssp_A,
        Gamma=[[1. / 2., 0, 0, 0], [0.0, 1. / 4., 0, 0],
               [-2., -2. / 3., 2. / 3., 0],
               [1. / 2., 5. / 36., -2. / 9, 0]],
        b=[1. / 6., 1. / 6., 1. / 6., 1. / 2.],
        bembed=[1. / 8., 3. / 4., 1. / 8., 0])
    register_rosw(
        "llssp3p4s2c", 3, A=ssp_A,
        Gamma=[[1. / 2., 0, 0, 0], [0.0, 3. / 4., 0, 0],
               [-2. / 3., -23. / 9., 2. / 9., 0],
               [1. / 18., 65. / 108., -2. / 27, 0]],
        b=[1. / 6., 1. / 6., 1. / 6., 1. / 2.],
        bembed=[3. / 16., 10. / 16., 3. / 16., 0])
    register_rosw(
        "ark3", 3,
        A=[[0, 0, 0, 0],
           [0.8717330430169179988320388950590125027645343373957631, 0, 0, 0],
           [0.5275890119763004115618079766722914408876108660811028,
            0.07241098802369958843819203208518599088698057726988732, 0, 0],
           [0.3990960076760701320627260685975778145384666450351314,
            -0.4375576546135194437228463747348862825846903771419953,
            1.038461646937449311660120300601880176655352737312713, 0]],
        Gamma=[[0.4358665215084589994160194475295062513822671686978816, 0, 0, 0],
               [-1.997527830934941248426324674704153457289527280554476,
                0.4358665215084589994160194475295062513822671686978816, 0, 0],
               [-1.007948511795029620852002345345404191008352770119903,
                -0.004648958462629345562774289390054679806993396798458131,
                0.4358665215084589994160194475295062513822671686978816, 0],
               [-0.6685429734233467180451604600279552604364311322650783,
                0.6056625986449338476089525334450053439525178740492984,
                -0.9717899277217721234705114616271378792182450260943198, 0]],
        b=[0.1876410243467238251612921333138006734899663569186926,
           -0.5952974735769549480478230473706443582188442040780541,
           0.9717899277217721234705114616271378792182450260943198,
           0.4358665215084589994160194475295062513822671686978816],
        bembed=[0.2147402862233891404862383521089097657790734483804460,
                -0.4851622638849390928209050538171743017757490232519684,
                0.8687250025203875511662123688667549217531982787600080,
                0.4016969751411624011684543450940068201770721128357014])
    register_ros4("grk4t", 0.231, e4=-0.1282612945269037e+01)
    register_ros4("shamp4", 0.5, e4=125. / 108.)
    register_ros4("veldd4", 0.22570811482256823492, e4=-1.355958941201148)
    register_ros4("4l", 0.57282, e4=-1.093502252409163)
    _ROSW_TABLEAUS["ros2"] = _ROSW_TABLEAUS["2p"]   # historical alias


_register_all_rosw()


def arkimex_tableaus():
    return sorted(_ARK_TABLEAUS)


def rosw_tableaus():
    return sorted(set(_ROSW_TABLEAUS) - {"ros2"})


# ---------------------------------------------------------------------------
# Steppers
# ---------------------------------------------------------------------------

def _integrate(step, u0: torch.Tensor, cfg: TSConfig) -> TSResult:
    """The IMEX steppers' loop: clamp_final selects the exact final time
    (t < max_time − 1e-14, dt = min(dt, max_time − t)) or STEPOVER."""
    tt = time_dtype(u0)
    t, u, dt, st = tt(cfg.t0), u0, tt(cfg.dt), 0
    while running(cfg, t, st, cfg.clamp_final):
        dt_eff = step_size(cfg, t, dt, cfg.clamp_final)
        u, dt_used, dt_next = step(t, u, dt_eff)
        _monitor(cfg, st + 1, t + dt_used, u)
        t, dt, st = t + dt_used, tt(dt_next), st + 1
    return result(u, t, st, dt)


def ts_arkimex(f_exp: Callable, f_imp: Callable, u0: torch.Tensor,
               cfg: TSConfig = None, axis: Optional[str] = None,
               tableau: str = "ars122", **kw) -> TSResult:
    """Additive IMEX-RK integration of u' = f_exp(t,u) + f_imp(t,u).

    The stage loop reproduces TSStep_ARKIMEX (arkimex.c:658): explicit
    stages (At_ii = 0) combine stored stage derivatives; implicit
    stages nest a Newton solve. With cfg.adapt and an embedded row, the
    basic step controller accepts/rejects on the order-(p−1) estimate.
    """
    cfg = configure(cfg, kw)
    try:
        tab = _ARK_TABLEAUS[tableau]
    except KeyError:
        raise ValueError(f"unknown arkimex tableau {tableau!r}; "
                         f"have {arkimex_tableaus()}") from None
    s, At, A = tab["s"], tab["At"], tab["A"]
    bt, b, ct, c = tab["bt"], tab["b"], tab["ct"], tab["c"]
    adapt = cfg.adapt and tab["bembedt"] is not None

    def step(t, u, dt):
        YdotI, YdotRHS = [], []
        y_prev = u
        for i in range(s):
            zi = u
            for j in range(i):
                if At[i, j]:
                    zi = zi + (dt * At[i, j]) * YdotI[j]
                if A[i, j]:
                    zi = zi + (dt * A[i, j]) * YdotRHS[j]
            if At[i, i] == 0.0:            # explicit stage
                yi = zi
            else:                          # implicit: Newton on the stage
                aii = At[i, i]
                ti = t + ct[i] * dt

                def G(y, zi=zi, aii=aii, ti=ti):
                    return y - zi - dt * aii * f_imp(ti, y)

                yi = snes_solve(G, y_prev, jac="jvp", cfg=cfg.snes,
                                ksp_cfg=cfg.ksp, axis=axis).x
            y_prev = yi
            YdotI.append(f_imp(t + ct[i] * dt, yi))
            YdotRHS.append(f_exp(t + c[i] * dt, yi))
        un = u
        for j in range(s):
            if bt[j]:
                un = un + (dt * bt[j]) * YdotI[j]
            if b[j]:
                un = un + (dt * b[j]) * YdotRHS[j]
        if not adapt:
            return un, dt, dt
        ue = u
        for j in range(s):
            if tab["bembedt"][j]:
                ue = ue + (dt * tab["bembedt"][j]) * YdotI[j]
            if tab["bembed"][j]:
                ue = ue + (dt * tab["bembed"][j]) * YdotRHS[j]
        return _basic_controller(cfg, tab["order"], un, un - ue, u, dt, axis)

    return _integrate(step, u0, cfg)


def ts_rosw(rhs: Callable, u0: torch.Tensor, cfg: TSConfig = None,
            axis: Optional[str] = None, tableau: str = "2p",
            jac_fn: Optional[Callable] = None, **kw) -> TSResult:
    """Rosenbrock-W integration of u' = rhs(t, u).

    One Jacobian per step (frozen at (t, u) — the W-property), one
    linear solve per implicit stage in the reference's transformed
    variables (TSStep_RosW + the SNESKSPONLY policy, rosw.c:1417).
    Explicit stages (Γ_ii = 0) use the GammaExplicitCorr Jacobian
    correction so W-order is retained.

    jac_fn: optional rhs-form function whose (frozen) Jacobian is used
    in the stage solves instead of the exact d(rhs)/du — the W-property
    tolerates inexact J. This is the TSSetIJacobian IMEX usage (ts
    ex22 run under -ts_type rosw: J from the stiff reaction only,
    advection Jacobian omitted); matching the reference's trajectories
    digit-for-digit requires the SAME approximate J.
    """
    cfg = configure(cfg, kw)
    try:
        tab = _ROSW_TABLEAUS[tableau]
    except KeyError:
        raise ValueError(f"unknown rosw tableau {tableau!r}; "
                         f"have {rosw_tableaus()}") from None
    s, At, Gamma = tab["s"], tab["At"], tab["Gamma"]
    GammaInv, GEC = tab["GammaInv"], tab["GammaExplicitCorr"]
    gzd, ASum, bt = tab["GammaZeroDiag"], tab["ASum"], tab["bt"]
    adapt = cfg.adapt and tab["bembedt"] is not None
    solver = KSP_REGISTRY[cfg.ksp.ksp_type]
    jsrc = jac_fn if jac_fn is not None else rhs
    n = u0.shape[0]

    def step(t, u, dt):
        def jmul(v):                        # frozen J = ∂jsrc/∂u at (t, u)
            return torch.func.jvp(lambda w: jsrc(t, w), (u,), (v,))[1]

        Y = []
        for i in range(s):
            ti = t + ASum[i] * dt
            zstage = u
            zdot = torch.zeros_like(u)
            for j in range(i):
                if At[i, j]:
                    zstage = zstage + At[i, j] * Y[j]
                if GammaInv[i, j]:
                    zdot = zdot + (GammaInv[i, j] / dt) * Y[j]
            fi = rhs(ti, zstage) - zdot
            if gzd[i]:                      # explicit stage w/ W-correction
                corr = torch.zeros_like(u)
                for j in range(i):
                    if GEC[i, j]:
                        corr = corr + GEC[i, j] * Y[j]
                yi = dt * (fi + jmul(corr))
            else:
                shift = 1.0 / (Gamma[i, i] * dt)
                Aop = Shell(ctx=shift,
                            mult_fn=lambda sh, v: sh * v - jmul(v),
                            shape=(n, n))
                yi = solver(Aop, fi, torch.zeros_like(u), None, cfg.ksp,
                            axis).x
            Y.append(yi)
        un = u
        for j in range(s):
            if bt[j]:
                un = un + bt[j] * Y[j]
        if not adapt:
            return un, dt, dt
        ue = u
        for j in range(s):
            if tab["bembedt"][j]:
                ue = ue + tab["bembedt"][j] * Y[j]
        return _basic_controller(cfg, tab["order"], un, un - ue, u, dt, axis)

    return _integrate(step, u0, cfg)
