"""Host utilities shared by the port's decoders and encoders."""
