"""Traffic models driven through the port's data plane."""
