"""Hub -> Space -> Version store semantics, in memory."""
