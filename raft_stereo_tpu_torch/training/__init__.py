"""One training step: loss, optimizer and schedule, the step itself."""
