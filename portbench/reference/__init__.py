"""The plain reference of a request, computed in the served dtype: PyTorch
and NumPy only, nothing of the program."""
