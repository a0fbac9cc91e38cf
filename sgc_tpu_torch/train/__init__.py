"""Head training: the Newton fit and the LBFGS oracle."""
