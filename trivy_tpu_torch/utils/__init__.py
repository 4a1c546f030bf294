"""Host utilities shared by the analyzers."""
