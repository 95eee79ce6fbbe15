"""Linear models on the descriptor basis (filter presets so far)."""
