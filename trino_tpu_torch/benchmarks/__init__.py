"""Query corpora (spec text) for the port's own benchmark scripts."""
