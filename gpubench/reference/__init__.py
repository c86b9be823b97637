"""Plain PyTorch references of what the cells run, in float32 with TF32
off.  They import nothing of the program and take nothing it made: the
harness hands them the same seeded tensors it handed the program."""
