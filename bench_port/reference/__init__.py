"""The benchmark's plain reference: float64 NumPy and PyTorch, importing
neither JAX nor the JAX package nor anything of gpr_calculator_tpu_torch.
It works out again from the benchmark's own inputs what the program
derives: descriptors, covariance blocks, the NLL, the hyperparameters
L-BFGS-B reaches, the factor and the served answers."""
