from petsctpu_torch.core.options import Options
from petsctpu_torch.core.errors import ConvergedReason, SNESConvergedReason

__all__ = ["Options", "ConvergedReason", "SNESConvergedReason"]
