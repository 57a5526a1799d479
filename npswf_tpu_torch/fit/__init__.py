"""The bounded LM fit: error model, Cholesky, solver and its kernel."""
