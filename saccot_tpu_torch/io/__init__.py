"""Input generation: synthetic correspondence problems (NumPy)."""
