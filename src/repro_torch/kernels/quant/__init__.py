"""Upload-codec quantizer (quantize, ef_accumulate, quantize_cols,
private_quantize_cols): plain versions, CUDA kernels, entry points."""
