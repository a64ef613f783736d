"""The benchmark's plain reference: ``ttref``, a frozen copy of the port's model,
renderer, guidance and trainer code with plain attention and a plain field grid in
place of the hand-written kernels. It imports nothing of the program."""
