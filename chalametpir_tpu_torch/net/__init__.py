"""Transport of the port: the JAX package's asyncio TCP server and client
with the reference wire framing, around the port's Server and Client."""
