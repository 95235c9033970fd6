"""Physics ops over (batched) torch scalars."""
