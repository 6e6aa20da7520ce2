"""The plain reference of the benchmark's correctness check.

Plain PyTorch (float32, TF32 off) and numpy, written from the upstream
project's description of the pipeline: the attention-UNet binarizer over
overlapping tiles, connected components grouped into glyph crops, the
glyph encoder (a family of ``encoders/``), the attentive LSTM decoder and
the inverse transform of its tokens into polylines. It imports nothing of the program under test
and nothing of JAX, and neither does any encoder family of ``encoders/``,
which is held to the same rule (``tests/test_bench_guard.py`` runs every
file of both): :mod:`.msgpack` reads the weight files itself, and
:mod:`.geometry` holds frozen copies of the host arithmetic that the
upstream project defines (its quirks included, each named where it is
kept).
"""
