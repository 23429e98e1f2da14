from petsctpu_torch.snes.api import SNES, snes_solve, SNESConfig, SNESResult
from petsctpu_torch.snes.fdjac import (ColoredJacobian, jvp_operator,
                                       mffd_operator)
from petsctpu_torch.snes.fas import (
    FASLevel, fas_levels_from_da, ngs_sweep, snes_fas, snes_ncg, snes_ngs,
)
from petsctpu_torch.snes.nasm import snes_ms, snes_multiblock, snes_nasm
from petsctpu_torch.snes.variants import (
    snes_anderson, snes_newtontr, snes_ngmres, snes_qn, snes_tr,
)
from petsctpu_torch.snes.vi import snes_vinewtonrsls, snes_vinewtonssls

__all__ = ["SNES", "snes_solve", "SNESConfig", "SNESResult",
           "ColoredJacobian", "jvp_operator", "mffd_operator",
           "FASLevel", "fas_levels_from_da", "ngs_sweep", "snes_fas",
           "snes_ncg", "snes_ngs", "snes_ms", "snes_multiblock", "snes_nasm",
           "snes_anderson", "snes_newtontr", "snes_ngmres", "snes_qn",
           "snes_tr", "snes_vinewtonrsls", "snes_vinewtonssls"]
