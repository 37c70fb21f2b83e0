from .build import (SGDMomentumCorrection, make_optimizer,
                    warmup_multistep_schedule)

__all__ = ["SGDMomentumCorrection", "make_optimizer",
           "warmup_multistep_schedule"]
