"""Device compute ops: scoring, boolean masks, fuzzy matching."""
