"""The plain reference: PyTorch alone, no part of the program (see README.md)."""
