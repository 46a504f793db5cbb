"""Expert-weight permutes: plain torch version, CUDA kernel wrapper, dispatcher."""
