"""The plain reference: float64 torch written from the problem's statement,
importing nothing of the program."""
