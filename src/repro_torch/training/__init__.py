"""Training/serving step factories and the fault-tolerant outer loop
(counterpart of ``repro/training``)."""
from repro_torch.training.step import (  # noqa: F401
    TrainState,
    make_decode_step,
    make_eval_step,
    make_prefill_step,
    make_train_step,
)
