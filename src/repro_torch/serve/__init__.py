from .frontend import QACFrontend, route_classes
from .qac import serve_multi_term, serve_single_term, serve_single_term_full

__all__ = ["QACFrontend", "route_classes", "serve_multi_term",
           "serve_single_term", "serve_single_term_full"]
