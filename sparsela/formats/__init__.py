from sparsela.formats.coo import CooMatrix
from sparsela.formats.csr import CsrMatrix
from sparsela.formats.bcsr import BcsrMatrix
