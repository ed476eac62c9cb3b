"""The plain reference: plain PyTorch, float32 unless a stated precision
says otherwise, TF32 off. It imports neither JAX nor the JAX package nor
anything of ``twotower_tpu_torch``, and takes nothing the program made."""
