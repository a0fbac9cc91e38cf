"""Build, device and timing helpers of the port."""
