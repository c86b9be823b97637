from .adamw import (OptimConfig, OptState, abstract_state, global_norm, init,
                    schedule_lr, update, update_)

__all__ = ["OptimConfig", "OptState", "abstract_state", "global_norm",
           "init", "schedule_lr", "update", "update_"]
