"""Training of the port: losses, optimizer state and the train loop."""
