"""The plain reference: float64 PyTorch and NumPy, independent of the
program under test (it imports nothing of ``symtensor_tpu_torch``)."""
