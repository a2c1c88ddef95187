"""`ae_roofline.<suffix>`: the segment's autoencoder calls' roofline time (fp32
FLOPs at 67 TFLOP/s or bytes at 3.35 TB/s, `perfbench/ae_counts.py`) over
their spans' card time, in percent; None where the program's counters of its
AE calls and plain attention launches disagree with the shapes."""

from perfbench.ae_readers import ae_roofline as read  # noqa: F401
