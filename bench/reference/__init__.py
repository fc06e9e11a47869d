"""The plain reference (`cpd`) and the numbers that compare an answer with
it (`compare`). Plain PyTorch from COO inputs: nothing here imports the
port, JAX or the JAX package."""
