"""Registration criteria (NumPy)."""
