"""The plain reference: numpy and plain PyTorch, importing nothing of the
port, computing in float32 with TF32 off unless a control asks for less."""
