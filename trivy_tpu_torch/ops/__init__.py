"""Device operators of the port: the DFA sieve (its table, its CUDA
kernel and plain version) and the class-run gate."""
