"""Numerical ops: descriptor, operand packing and covariance kernels."""
