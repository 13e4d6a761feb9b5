"""Interactive web viewer: stdlib HTTP server over a render closure, camera
state and path recording; the same viewer as the JAX package's, serving
frames rendered by this package."""
