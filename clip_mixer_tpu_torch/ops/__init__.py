"""Operations of the port: image preprocessing and the CUDA kernels."""
