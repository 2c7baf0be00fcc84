"""Device ops: sparse formats, the ELL SpMM kernel, normalization,
propagation and message operators."""
