"""Plain PyTorch references: frozen copies of the mathematics the program
computes, importing nothing of the program."""
