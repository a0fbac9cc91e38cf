"""Datasets: the Planetoid and Reddit loaders, synthetic generators, and
writers of seeded files in the published formats."""
