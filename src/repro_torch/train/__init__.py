"""Training: the train step, optimizers, checkpoints and the straggler
monitor (the reference's ``repro/train``)."""
