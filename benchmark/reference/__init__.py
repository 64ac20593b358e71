"""The benchmark's plain reference: PyTorch operations in float32 with TF32
off, and no kernel, cache or batching trick of the program.

Each module is a frozen copy of the plain version of one layer of the
measured update, kept here so that no later change to the program can move
the yardstick. Nothing here imports the program: the reference gets the
same inputs as the program (frames, cameras, the triangle soup) and works
out everything else again.

``precision`` selects the arithmetic: ``"float32"`` (the configurations'
stated precision) or ``"tf32"``, the control, which rounds the operands of
every matrix product to TF32 as the tensor cores do.
"""
