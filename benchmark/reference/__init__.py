"""The plain reference: imports neither JAX nor the program."""
