"""Device operators of the port: the DFA sieve (its table, its CUDA
kernel and plain version), the literal-code sieve (its code table, its
CUDA kernel and plain versions), the class-run gate, and the builder
of the CUDA kernels."""
