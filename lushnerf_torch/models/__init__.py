"""Models: NeRF MLP, RBK blur kernel, renderer, tone mapping, LuSh-NeRF."""
