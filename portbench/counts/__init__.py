"""Operation counts of the model, from its configuration and shapes."""
