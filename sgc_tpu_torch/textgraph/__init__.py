"""Text-to-graph construction: the doc-word graph builder (``graph.py``)
and the word-embedding store (``embedding.py``)."""
