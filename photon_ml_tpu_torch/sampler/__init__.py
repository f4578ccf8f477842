"""Down-samplers of the fixed-effect coordinate."""
