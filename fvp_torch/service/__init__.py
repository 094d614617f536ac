"""The streaming service of the port: capture -> inference -> overlay."""
