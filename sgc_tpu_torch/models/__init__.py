"""Model heads."""
