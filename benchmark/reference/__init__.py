"""The plain reference: plain PyTorch, no module of the program. Each model
is a function of a parameter dict under the reference's state-dict keys."""
