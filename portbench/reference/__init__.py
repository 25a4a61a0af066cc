"""The plain reference of the benchmark: whisper log-mel, Kaldi fbank,
NeMo log-mel, the Sobel VAD and the u8 quantisation, written from the
semantics the configurations state, in plain PyTorch and NumPy. It imports
nothing of the program: every window and filterbank is worked out again
here.

``precision="float64"`` is the reference; ``precision="tf32"`` is its
control, the same arithmetic with every matrix product on operands
rounded to TF32 and the rest in float32."""
