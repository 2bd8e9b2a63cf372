"""Index implementations over integer row ids."""
