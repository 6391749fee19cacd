"""Transport-aware collective cost model over the port's simulator."""
