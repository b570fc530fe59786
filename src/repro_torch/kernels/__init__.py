# Hand-written CUDA kernels, one package each in the reference's idiom:
# ref.py (plain torch), kernel.py (the CUDA binding), ops.py (dispatch).
