"""Device operations of the port: ctr A generation, packed respond, the digit2 products, the client s . A engine."""
