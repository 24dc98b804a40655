"""Host utilities shared by the port's layers."""
