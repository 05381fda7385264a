"""Web output layer: interactive widget + main page + HTML statistics
(reference: src/mosaic/web/ + src/assets/)."""

from emosaic_tpu_torch.web.widget import generate_mosaic_widget_with_options  # noqa: F401
from emosaic_tpu_torch.web.main_page import generate_html_with_options  # noqa: F401
