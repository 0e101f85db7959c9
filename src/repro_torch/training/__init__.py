from repro_torch.training.loop import (make_train_step, param_tree,  # noqa: F401
                                       train)
from repro_torch.training.optimizer import (AdamW, Adafactor,  # noqa: F401
                                            cosine_schedule, make_optimizer)
