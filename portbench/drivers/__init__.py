"""One module a kind of traffic: `run(Context) -> Run`."""
