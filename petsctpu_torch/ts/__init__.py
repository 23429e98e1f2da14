from petsctpu_torch.ts.steppers import (
    TS, TSConfig, TSResult, ts_alpha, ts_pseudo, ts_solve,
)
from petsctpu_torch.ts.imex import ts_arkimex, ts_rosw
from petsctpu_torch.ts.characteristic import (characteristic_step,
                                              ts_characteristic)
from petsctpu_torch.ts.gl import ts_gl

__all__ = ["TS", "TSConfig", "TSResult", "ts_alpha", "ts_pseudo",
           "ts_solve", "ts_arkimex", "ts_rosw", "ts_characteristic",
           "characteristic_step", "ts_gl"]
