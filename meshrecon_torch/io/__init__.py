"""Scene input and mesh output: track YAML, OBJ files, synthetic frames."""
