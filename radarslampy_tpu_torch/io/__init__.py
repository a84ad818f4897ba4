"""Host-side I/O: Oxford Radar RobotCar sequences (numpy + PIL)."""
