"""Tuned hyperparameter tables (``tuned.json``), read by utils/config.py."""
