from petsctpu_torch.core.options import Options
from petsctpu_torch.core.errors import ConvergedReason, SNESConvergedReason
from petsctpu_torch.core.layout import Layout

__all__ = ["Options", "ConvergedReason", "SNESConvergedReason", "Layout"]
