"""KV page gather/scatter: plain torch version, CUDA kernel wrapper, dispatcher."""
