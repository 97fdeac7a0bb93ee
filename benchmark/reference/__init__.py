"""The plain reference: float32 PyTorch with TF32 off, written from the
models' published description and independent of the program under test
(it imports nothing of it)."""
